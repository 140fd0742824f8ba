"""CoCa (vitlens_tpu_torch/models/coca.py) against the JAX package's on the
CPU, at the tiny config of tests/test_coca.py (embed 32; vision 28/14, width
32 x 2; text ctx 12, vocab 64, width 32 x 2; decoder 32 x 2, ctx 11; 8
queries). Weights: ``coca_init(PRNGKey(0))`` copied by
``weights/from_jax.load_coca_params``; inputs from numpy seeds.

Tolerances: the CLS mask cell for cell; each module, the forward and the
loss in fp32 within 1e-5 of the largest magnitude; every gradient leaf
within 1e-4; bf16 features and logits by cosine >= 0.999 against JAX's bf16
run; greedy and beam tokens equal; the logits processors within 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from vitlens_tpu.config import TextArch as JTextArch
from vitlens_tpu.config import VisionArch as JVisionArch
from vitlens_tpu.models import coca as JC
from vitlens_tpu_torch import config as PCfg
from vitlens_tpu_torch.models import coca as PC
from vitlens_tpu_torch.parallel.mesh import make_mesh
from vitlens_tpu_torch.train.losses import coca_loss
from vitlens_tpu_torch.weights.from_jax import flatten, load_coca_params
from tests.test_torch_threads import share_cores

share_cores()

GEN_KW = dict(sot_token_id=1, eos_token_id=63, pad_token_id=0, seq_len=8,
              min_seq_len=1)
# an EOS the tiny model does emit (token 58, from the third position on):
# exercises the finished pool, its normalisation and the trimmed output
EOS_KW = dict(GEN_KW, eos_token_id=58, repetition_penalty=1.3)


def _configs():
    j = JC.CoCaConfig(
        embed_dim=32,
        vision=JVisionArch(image_size=28, patch_size=14, width=32, layers=2,
                           head_width=16),
        text=JTextArch(context_length=12, vocab_size=64, width=32, heads=2,
                       layers=2),
        multimodal=JC.MultimodalArch(width=32, heads=2, layers=2,
                                     context_length=11),
        n_queries=8)
    p = PC.CoCaConfig(
        embed_dim=32,
        vision=PCfg.VisionArch(image_size=28, patch_size=14, width=32,
                               layers=2, head_width=16),
        text=PCfg.TextArch(context_length=12, vocab_size=64, width=32, heads=2,
                           layers=2),
        multimodal=PC.MultimodalArch(width=32, heads=2, layers=2,
                                     context_length=11),
        n_queries=8)
    return j, p


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = _configs()
    params, state = JC.coca_init(jax.random.PRNGKey(0), jcfg)
    model = PC.CoCa(pcfg, device="cpu")
    load_coca_params(model, params, state)
    return jcfg, pcfg, params, state, model


def _images(seed, b=2):
    return np.random.RandomState(seed).randn(b, 3, 28, 28).astype(np.float32)


def _captions(seed=0):
    rng = np.random.RandomState(seed)
    text = np.zeros((2, 12), np.int32)
    text[:, 0] = 1
    text[:, 1:5] = rng.randint(2, 60, (2, 4))
    text[:, 5] = 63  # a pad tail after EOS
    text[1, 6:9] = rng.randint(2, 60, 3)
    text[1, 9] = 63
    return text


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _np(t):
    return t.detach().double().numpy()


def _cos_min(got, want):
    got = np.asarray(got, np.float64).reshape(-1, np.shape(got)[-1])
    want = np.asarray(want, np.float64).reshape(-1, np.shape(want)[-1])
    return ((got * want).sum(-1) / np.linalg.norm(got, axis=-1)
            / np.linalg.norm(want, axis=-1)).min()


def test_cls_attn_mask_matches_jax():
    """The three caption shapes of JAX's mask test: padded, last token
    padded, unpadded; cell for cell, -inf included."""
    rng = np.random.RandomState(0)
    text = rng.randint(1, 50, size=(3, 7)).astype(np.int32)
    text[0, 4:] = 0
    text[1, 6:] = 0
    want = np.asarray(JC.coca_cls_attn_mask(jnp.asarray(text), 0))
    got = PC.coca_cls_attn_mask(torch.from_numpy(text).long(), 0)
    assert got.dtype == torch.float32 and got.shape == (3, 1, 8, 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("part", ["pooler", "text_tower", "decoder",
                                  "encode_image"])
def test_module_matches_jax_fp32(setup, part):
    jcfg, pcfg, params, state, model = setup
    rng = np.random.RandomState(3)
    if part == "pooler":
        x = rng.randn(2, 5, 32).astype(np.float32)
        want = [JC.attentional_pooler_apply(params["visual"]["attn_pool"],
                                            jnp.asarray(x), heads=8)]
        got = [model.visual.attn_pool(torch.from_numpy(x), 8)]
    elif part == "text_tower":
        text = _captions()[:, :-1]
        want = jax.jit(lambda p: JC.cls_text_tower_apply(
            p, jnp.asarray(text), jcfg.text, pad_id=0))(params["text"])
        got = model.encode_text(torch.from_numpy(text).long())
        assert got[1].shape == (2, 11, 32)  # tokens, before ln_final
    elif part == "decoder":
        img = rng.randn(2, 8, 32).astype(np.float32)
        txt = rng.randn(2, 9, 32).astype(np.float32)
        want = [jax.jit(lambda p: JC.multimodal_decoder_apply(
            p, jnp.asarray(img), jnp.asarray(txt), jcfg.multimodal))(
                params["text_decoder"])]
        got = [model.text_decoder(torch.from_numpy(img), torch.from_numpy(txt))]
    else:
        images = _images(4)
        want = jax.jit(lambda p: JC.coca_encode_image(
            p, jnp.asarray(images), jcfg))(params)
        got = model.encode_image(torch.from_numpy(images))
        assert got[0].shape == (2, 32) and got[1].shape == (2, 8, 32)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(_np(g), w) <= 1e-5


def test_forward_and_loss_match_jax_fp32(setup):
    jcfg, pcfg, params, state, model = setup
    images, text = _images(0), _captions()
    want = jax.jit(lambda p: JC.coca_forward(
        p, state, jnp.asarray(images), jnp.asarray(text), jcfg))(params)
    got = model(torch.from_numpy(images), torch.from_numpy(text).long())
    for k in ("image_features", "text_features", "logits", "logit_scale"):
        assert _rel(_np(got[k]), want[k]) <= 1e-5, k
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    for g, w in zip(coca_loss(got, pcfg), JC.coca_loss(want, jcfg)):
        assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w))
    # the data axis: unbound without a process group (JAX's name is unbound
    # outside shard_map); a one-device mesh gathers nothing
    with pytest.raises(RuntimeError, match="unbound"):
        coca_loss(got, pcfg, axis_name="data")
    one = make_mesh(devices=["cpu"])
    for g, w in zip(coca_loss(got, pcfg, axis_name=one), coca_loss(got, pcfg)):
        assert float(g) == float(w)


def test_gradients_match_jax_fp32(setup):
    """Every leaf of jax.grad(contrastive + caption) against autograd of the
    port's, by the flattened tree, within 1e-4 of the leaf's largest
    magnitude."""
    import copy

    jcfg, pcfg, params, state, model = setup
    images, text = _images(0), _captions()

    def loss_fn(p):
        c, cap = JC.coca_loss(JC.coca_forward(p, state, jnp.asarray(images),
                                              jnp.asarray(text), jcfg), jcfg)
        return c + cap

    want = flatten(jax.jit(jax.grad(loss_fn))(params))
    m = copy.deepcopy(model)
    for p in m.parameters():
        p.requires_grad_(True)
    c, cap = coca_loss(m(torch.from_numpy(images),
                         torch.from_numpy(text).long()), pcfg)
    (c + cap).backward()
    got = {n: p.grad for n, p in m.named_parameters()}
    assert sorted(got) == sorted(want)
    worst = {n: _rel(_np(got[n]), want[n]) for n in want}
    assert max(worst.values()) <= 1e-4, sorted(worst.items(), key=lambda kv: -kv[1])[:5]


def test_bf16_matches_jax_and_counts_kernel_calls(setup, monkeypatch):
    """bf16 on the CPU: features and logits by cosine against JAX's bf16
    run; the kernel wrappers (their plain versions here) are called as
    chip_smoke.coca_launches derives from the config, for the forward, the
    encode and a generate."""
    from vitlens_tpu_torch.models import layers as PL
    from vitlens_tpu_torch.ops import attention as PA

    jcfg, pcfg, params, state, model = setup
    calls = {"fused_mlp": 0, "flash_attention": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(PL, "fused_mlp", counted("fused_mlp", PL.fused_mlp))
    monkeypatch.setattr(PA, "flash_attention",
                        counted("flash_attention", PA.flash_attention))

    def count(fn):
        for k in calls:
            calls[k] = 0
        out = fn()
        return out, dict(calls)

    def subset(want):
        return {k: want[k] for k in calls}

    images, text = _images(0), _captions()
    bf = torch.bfloat16
    want = jax.jit(lambda p: JC.coca_forward(
        p, state, jnp.asarray(images), jnp.asarray(text), jcfg,
        compute_dtype=jnp.bfloat16))(params)
    with torch.no_grad():
        got, n = count(lambda: model(torch.from_numpy(images),
                                     torch.from_numpy(text).long(), bf))
    for k in ("image_features", "text_features", "logits"):
        assert got[k].dtype == bf
        assert _cos_min(got[k].float().numpy(),
                        np.asarray(want[k].astype(jnp.float32))) >= 0.999, k
    assert n == subset(chip_smoke.coca_launches(pcfg, "forward"))
    with torch.no_grad():
        _, n = count(lambda: model.encode_image(torch.from_numpy(images), bf))
    assert n == subset(chip_smoke.coca_launches(pcfg, "encode"))
    _, n = count(lambda: PC.coca_generate(
        model, torch.from_numpy(images), num_beams=2, num_beam_groups=1,
        compute_dtype=bf, **GEN_KW))
    assert n == subset(chip_smoke.coca_launches(pcfg, "generate",
                                                steps=GEN_KW["seq_len"] - 1))


@pytest.fixture(scope="module")
def jax_greedy(setup):
    """JAX's greedy tokens at seq_len 7. Its seq_len-5 tokens are the first
    six columns: each step decodes only the columns before it."""
    jcfg, pcfg, params, state, model = setup
    return np.asarray(jax.jit(lambda p: JC.coca_generate_greedy(
        p, state, jnp.asarray(_images(1)), jcfg, sot_token=1, eot_token=63,
        seq_len=7))(params))


@pytest.mark.parametrize("seq_len", [5, 7])
def test_greedy_tokens_equal_jax(setup, jax_greedy, seq_len):
    model = setup[-1]
    got = PC.coca_generate_greedy(model, torch.from_numpy(_images(1)), 1, 63,
                                  seq_len)
    assert got.shape == (2, seq_len + 1)
    np.testing.assert_array_equal(got.numpy(), jax_greedy[:, :seq_len + 1])


@pytest.mark.parametrize("beams,groups,kw", [(4, 2, GEN_KW), (1, 1, GEN_KW),
                                             (4, 2, EOS_KW)])
def test_beam_tokens_equal_jax(setup, beams, groups, kw):
    jcfg, pcfg, params, state, model = setup
    images = _images(1)
    want = np.asarray(JC.coca_generate(
        params, state, jnp.asarray(images), jcfg, generation_type="beam_search",
        num_beams=beams, num_beam_groups=groups, **kw))
    got = PC.coca_generate(model, torch.from_numpy(images),
                           generation_type="beam_search", num_beams=beams,
                           num_beam_groups=groups, **kw)
    assert got.shape == (2, kw["seq_len"])
    np.testing.assert_array_equal(got.numpy(), want)
    if kw is EOS_KW:  # the finished pool was taken: rows end early
        assert (want == 0).any()
        trimmed = JC.coca_generate(params, state, jnp.asarray(images), jcfg,
                                   generation_type="beam_search",
                                   num_beams=beams, num_beam_groups=groups,
                                   fixed_output_length=False, **kw)
        got_t = PC.coca_generate(model, torch.from_numpy(images),
                                 generation_type="beam_search",
                                 num_beams=beams, num_beam_groups=groups,
                                 fixed_output_length=False, **kw)
        assert got_t.shape[1] < kw["seq_len"]
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(trimmed))


def _fixed_scores():
    rng = np.random.RandomState(0)
    return (rng.randn(3, 50).astype(np.float32),
            rng.randint(0, 50, (3, 6)).astype(np.int64))


def _tied_scores():
    """Rows with exact ties at the k-th place and across the top-p cut."""
    s = np.full((3, 12), -2.0, np.float32)
    s[0, [1, 4, 7]] = 1.5           # three-way tie for the top
    s[1, [0, 11]] = 3.0             # two tied leaders at both ends
    s[1, [3, 5, 8]] = 0.25
    s[2] = np.linspace(1.0, 0.0, 12, dtype=np.float32).round(1)
    s[2, 9:] = s[2, 8]              # a tail of ties
    return s


@pytest.mark.parametrize("name", ["min_length", "repetition", "top_k", "top_p",
                                  "top_k_ties", "top_p_ties"])
def test_logits_processors_match_jax(name):
    scores, ids = _fixed_scores()
    if name.endswith("ties"):
        scores = _tied_scores()
    s_j, s_t = jnp.asarray(scores), torch.from_numpy(scores)
    if name == "min_length":
        for cur in (6, 10):
            np.testing.assert_allclose(
                PC._min_length_mask(s_t, cur, 10, 7).numpy(),
                np.asarray(JC._min_length_mask(s_j, cur, 10, 7)), rtol=1e-6)
        return
    if name == "repetition":
        valid = np.ones_like(ids, bool)
        valid[:, 4:] = False
        want = JC._repetition_penalty(s_j, jnp.asarray(ids), jnp.asarray(valid),
                                      1.3)
        got = PC._repetition_penalty(s_t, torch.from_numpy(ids),
                                     torch.from_numpy(valid), 1.3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        return
    for arg in ((1, 3, 5) if name.startswith("top_k") else (0.1, 0.6, 0.95)):
        if name.startswith("top_k"):
            want, got = JC._top_k_warp(s_j, arg), PC._top_k_warp(s_t, arg)
        else:
            want, got = JC._top_p_warp(s_j, arg), PC._top_p_warp(s_t, arg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        # the warped distribution a sample is drawn from
        np.testing.assert_allclose(
            torch.softmax(got / 0.7, -1).numpy(),
            np.asarray(jax.nn.softmax(want / 0.7, -1)), rtol=1e-5, atol=1e-7)


def test_top_k_breaks_ties_to_the_lower_index():
    x = torch.tensor([[0.0, 2.0, 1.0, 2.0, 2.0, -1.0]])
    vals, idx = PC._top_k(x, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert idx.tolist() == [[1, 3, 4, 2]] == np.asarray(ji).tolist()
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    neg = torch.full((1, 5), float("-inf"))
    assert PC._top_k(neg, 3)[1].tolist() == [[0, 1, 2]]


@pytest.mark.parametrize("mode", ["top_k", "top_p"])
def test_sampling_from_a_generator(setup, mode):
    """Seeded draws repeat; rows are pad-only after EOS; the last position
    is EOS unless the row ended before; top_k=1 is greedy up to the first
    EOS; no generator raises."""
    jcfg, pcfg, params, state, model = setup
    images = torch.from_numpy(_images(2))
    kw = dict(generation_type=mode, temperature=0.7, **GEN_KW,
              **({"top_k": 5} if mode == "top_k" else {"top_p": 0.8}))

    def draw(seed):
        return PC.coca_generate(model, images,
                                generator=torch.Generator().manual_seed(seed),
                                **kw).numpy()

    a, b = draw(0), draw(0)
    np.testing.assert_array_equal(a, b)
    assert not all(np.array_equal(a, draw(s)) for s in (1, 2, 3))
    for row in a:
        assert row[0] == 1 and ((row >= 0) & (row < 64)).all()
        eos = np.nonzero(row == 63)[0]
        assert len(eos), row  # the last position is forced to EOS
        assert (row[eos[0] + 1:] == 0).all()
    with pytest.raises(ValueError, match="generator"):
        PC.coca_generate(model, images, generation_type=mode, **GEN_KW)
    if mode == "top_k":
        greedy = PC.coca_generate_greedy(model, images, 1, 63, 7).numpy()
        top1 = PC.coca_generate(model, images, generation_type="top_k", top_k=1,
                                generator=torch.Generator().manual_seed(5),
                                **GEN_KW).numpy()
        beam1 = PC.coca_generate(model, images, generation_type="beam_search",
                                 num_beams=1, num_beam_groups=1,
                                 **GEN_KW).numpy()
        for b_ in range(2):
            eos = np.nonzero(greedy[b_] == 63)[0]
            stop = min(int(eos[0]) if len(eos) else 8, 7)
            np.testing.assert_array_equal(top1[b_, :stop], greedy[b_, :stop])
            np.testing.assert_array_equal(beam1[b_, :stop], greedy[b_, :stop])


def test_presets_and_entry_point(monkeypatch):
    """Both presets transcribed exactly; make_coca builds on the card unless
    device="cpu" is given."""
    import dataclasses

    for name in ("coca_ViT-B-32", "coca_ViT-L-14"):
        j, p = JC.make_coca_config(name), PC.make_coca_config(name)
        assert dataclasses.asdict(j) == dataclasses.asdict(p)
    l14 = PC.make_coca_config("coca_ViT-L-14")
    assert l14.vision.heads == 16 and l14.embed_dim // l14.attn_pooler_heads == 96
    with pytest.raises(KeyError):
        PC.make_coca_config("coca_ViT-H-14")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PC.make_coca("coca_ViT-B-32")
