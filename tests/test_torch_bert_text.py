"""The BERT-family text tower (vitlens_tpu_torch/models/bert_text.py), the
hf-text converter, the TriModel hf branch, HFTokenizer and the host
HFTextEncoder against the JAX package on the CPU, at small widths. The
transformers models are built from configs and saved to a temp dir (no
download); the vocab is written there. fp32: 1e-5 of each output's largest
magnitude (the transformers encoder itself: 1e-4, its own op order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.reference_layout import hf_bert_state_dict
from vitlens_tpu import config as JC
from vitlens_tpu.models import bert_text as JB
from vitlens_tpu.models import tri as JT
from vitlens_tpu.weights import torch_convert as JTC
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.models import bert_text as PB
from vitlens_tpu_torch.models import tri as PT
from vitlens_tpu_torch.models.tri import TriModel
from vitlens_tpu_torch.weights import torch_convert as PTC
from vitlens_tpu_torch.weights.from_jax import flatten, load_tri_params
from tests.test_torch_threads import share_cores

share_cores()

transformers = pytest.importorskip("transformers")

H, L, HEADS, INTER, VOCAB, MAXPOS = 32, 2, 4, 64, 60, 20


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


def _ids(style, b=3, n=10, seed=0):
    rng = np.random.RandomState(seed)
    pad = 1 if style == "roberta" else 0
    ids = rng.randint(3, VOCAB, size=(b, n)).astype(np.int32)
    for i, length in enumerate((n, n - 3, 4)[:b]):
        ids[i, length:] = pad
    return ids, (ids != pad).astype(np.int32)


def _hf_model(style, pooler=True):
    torch.manual_seed(0)
    if style == "roberta":
        cfg = transformers.RobertaConfig(
            vocab_size=VOCAB, hidden_size=H, num_hidden_layers=L,
            num_attention_heads=HEADS, intermediate_size=INTER,
            max_position_embeddings=MAXPOS, type_vocab_size=1, pad_token_id=1)
        return transformers.RobertaModel(cfg, add_pooling_layer=pooler).eval()
    cfg = transformers.BertConfig(
        vocab_size=VOCAB, hidden_size=H, num_hidden_layers=L,
        num_attention_heads=HEADS, intermediate_size=INTER,
        max_position_embeddings=MAXPOS, hidden_act="gelu")
    return transformers.BertModel(cfg, add_pooling_layer=pooler).eval()


@pytest.mark.parametrize("style,pooler", [("bert", True), ("roberta", True),
                                          ("bert", False)])
def test_encoder_from_saved_transformers_model(tmp_path, style, pooler):
    """A saved transformers BertModel/RobertaModel -> both converters (the
    same tree) -> the port's encoder equals JAX's and transformers' own."""
    hf = _hf_model(style, pooler)
    hf.save_pretrained(tmp_path)
    sd = type(hf).from_pretrained(tmp_path, add_pooling_layer=pooler).state_dict()
    want_tree = JB.convert_hf_bert_state_dict(sd)
    tree = PB.convert_hf_bert_state_dict(sd)
    assert (tree["pooler"] is None) == (not pooler)
    fw, fg = flatten(want_tree), flatten(tree)
    assert sorted(fw) == sorted(fg)
    for k in fw:
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    enc = PB.BertEncoder(VOCAB, H, L, HEADS, INTER, MAXPOS,
                         type_vocab_size=1 if style == "roberta" else 2,
                         eps=PB.LN_EPS_ROBERTA if style == "roberta" else PB.LN_EPS)
    if not pooler:
        enc.drop_pooler()
    from vitlens_tpu_torch.weights.from_jax import load_params
    load_params(enc, tree)
    pad = 1 if style == "roberta" else 0
    ids, mask = _ids(style)
    want_h, want_p = JB.bert_encoder_apply(want_tree, jnp.asarray(ids),
                                           jnp.asarray(mask), HEADS, style, pad)
    got_h, got_p = enc(torch.from_numpy(ids), torch.from_numpy(mask), style, pad)
    assert _rel(got_h.detach().numpy(), want_h) < 1e-5
    assert _rel(got_p.detach().numpy(), want_p) < 1e-5
    with torch.no_grad():
        out = hf(input_ids=torch.from_numpy(ids).long(),
                 attention_mask=torch.from_numpy(mask).long())
    m = mask[..., None].astype(bool)
    np.testing.assert_allclose(np.where(m, got_h.detach().numpy(), 0),
                               np.where(m, out.last_hidden_state.numpy(), 0),
                               atol=1e-4 * np.abs(out.last_hidden_state.numpy()).max())


@pytest.mark.parametrize("pooler_type", ["mean_pooler", "max_pooler", "cls_pooler",
                                         "cls_last_hidden_state_pooler"])
@pytest.mark.parametrize("proj", ["linear", "mlp"])
def test_hf_text_tower_matches_jax(pooler_type, proj):
    t_kw = dict(context_length=10, vocab_size=VOCAB, width=H, heads=HEADS,
                layers=L, hf_style="roberta", hf_intermediate=INTER,
                hf_max_positions=MAXPOS, hf_pad_id=1, hf_pooler_type=pooler_type,
                hf_proj=proj)
    jt, pt = JC.TextArch(**t_kw), PC.TextArch(**t_kw)
    params = JB.hf_text_tower_init(jax.random.PRNGKey(0), jt, 24)
    tower = PB.HFTextTower(pt, 24)
    PB.load_hf_text_tower(tower, params)
    ids, _ = _ids("roberta", seed=1)
    want = JB.hf_text_tower_apply(params, jnp.asarray(ids), jt)
    got = tower(torch.from_numpy(ids))
    assert got.shape == (3, 24)
    assert _rel(got.detach().numpy(), want) < 1e-5
    cos = torch.nn.functional.cosine_similarity(
        tower(torch.from_numpy(ids), torch.bfloat16).float(), got, dim=-1)
    assert cos.min() > 0.99


def _tiny_hf(C, style="roberta"):
    base = C.make_model_config("ViT-Tiny-Test", "image")
    text = C.TextArch(context_length=10, vocab_size=VOCAB, width=H, heads=HEADS,
                      layers=L, hf_style=style, hf_intermediate=INTER,
                      hf_max_positions=MAXPOS, hf_pad_id=1)
    return dataclasses.replace(base, text=text)


def test_tri_model_hf_branch_and_converter():
    """TriModel builds the BERT tower for an hf arch; a JAX tri tree loads
    whole and encode_text equals JAX's; an open_clip file with
    text.transformer.* and text.proj.{0,2} converts as JAX converts it."""
    jcfg, pcfg = _tiny_hf(JC), _tiny_hf(PC)
    params, _ = JT.tri_model_init(jax.random.PRNGKey(3), jcfg)
    model = load_tri_params(TriModel(pcfg, device="cpu"), params)
    assert isinstance(model.text, PB.HFTextTower)
    ids, _ = _ids("roberta", seed=2)
    want = JT.encode_text(params, jnp.asarray(ids), jcfg, normalize=True)
    got = PT.encode_text(model, torch.from_numpy(ids), normalize=True)
    assert _rel(got.detach().numpy(), want) < 1e-5
    g = torch.Generator().manual_seed(4)
    sd = hf_bert_state_dict(g, VOCAB, H, L, INTER, MAXPOS, type_vocab_size=1,
                            prefix="text.transformer.")
    sd["text.proj.0.weight"] = torch.randn(28, H, generator=g) * 0.1
    sd["text.proj.2.weight"] = torch.randn(32, 28, generator=g) * 0.1
    jp, _ = JTC.convert_tri_state_dict(sd, jcfg)
    pp, _ = PTC.convert_tri_state_dict(sd, pcfg)
    fw, fg = flatten(jp["text"]), flatten(pp["text"])
    assert sorted(fw) == sorted(fg)
    for k in fw:
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)


def _vocab_dir(tmp_path):
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "dog", "barking",
             "in", "the", "rain", "on", "roof", "tin", "##s"]
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(words) + "\n")
    tok = transformers.BertTokenizer(str(vocab))
    out = tmp_path / "tok"
    tok.save_pretrained(str(out))
    return str(out)


def test_hf_tokenizer_from_written_vocab(tmp_path):
    from vitlens_tpu.text import tokenizer as JTok
    from vitlens_tpu_torch.text import tokenizer as PTok

    d = _vocab_dir(tmp_path)
    texts = ["a dog  barking in the rain", "rain on the tin roofs", "zebra"]
    want = JTok.HFTokenizer(d)(texts, context_length=8)
    got = PTok.get_tokenizer(hf_tokenizer_name=d)(texts, context_length=8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(PTok.HFTokenizer(d)("a dog", 8),
                                  JTok.HFTokenizer(d)("a dog", 8))
    with pytest.raises(RuntimeError, match="tokenizer files locally"):
        PTok.HFTokenizer(str(tmp_path / "missing"))


def test_trainer_tokenizer_for_hf_archs(tmp_path, monkeypatch):
    """cli.train's tokenizer is the arch's HF tokenizer (CLIP BPE otherwise)."""
    from vitlens_tpu_torch.cli import train as CT
    from vitlens_tpu_torch.text.tokenizer import HFTokenizer, SimpleTokenizer

    d = _vocab_dir(tmp_path)
    cfg = _tiny_hf(PC)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, hf_tokenizer_name=d))
    assert isinstance(CT._tokenizer(cfg), HFTokenizer)
    assert isinstance(CT._tokenizer(None), SimpleTokenizer)


@pytest.mark.parametrize("pooler_type", ["mean_pooler", "cls_pooler",
                                         "cls_last_hidden_state_pooler"])
def test_host_hf_text_encoder_matches_jax(tmp_path, pooler_type):
    """models/hf_text.py's HFTextEncoder (transformers on the host) from a
    local directory: the same outputs as the JAX package's."""
    from vitlens_tpu.models.hf_text import HFTextEncoder as JH
    from vitlens_tpu_torch.models.hf_text import HFTextEncoder as PH

    _hf_model("bert").save_pretrained(tmp_path)
    ids, mask = _ids("bert", seed=5)
    j = JH(str(tmp_path), 16, pooler_type=pooler_type, proj="mlp")
    p = PH(str(tmp_path), 16, pooler_type=pooler_type, proj="mlp",
           device="cpu", seed=1)
    # the projections are drawn from different generators: give the port
    # JAX's draw, then the whole encode must match
    p.proj.load_state_dict(j.proj.state_dict())
    np.testing.assert_array_equal(p.encode(ids, mask), j.encode(ids, mask))
    with pytest.raises(RuntimeError, match="local path"):
        PH(str(tmp_path / "missing"), 16, device="cpu")


@pytest.mark.parametrize("proj", ["linear", "mlp"])
def test_host_hf_text_encoder_device_and_generator(tmp_path, monkeypatch,
                                                   proj):
    """HFTextEncoder runs on the card by default (raises without CUDA unless
    device="cpu"); its projection comes from the seeded generator alone,
    with nn.Linear's default bound 1/sqrt(fan_in), untouched by the global
    RNG."""
    from vitlens_tpu_torch.models.hf_text import HFTextEncoder as PH

    _hf_model("bert").save_pretrained(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PH(str(tmp_path), 16, proj=proj)
    torch.manual_seed(0)
    a = PH(str(tmp_path), 16, proj=proj, device="cpu", seed=3)
    torch.manual_seed(99)
    b = PH(str(tmp_path), 16, proj=proj, device="cpu", seed=3)
    c = PH(str(tmp_path), 16, proj=proj, device="cpu", seed=4)
    assert a.device == torch.device("cpu")
    sa, sb, sc = (m.proj.state_dict() for m in (a, b, c))
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
        assert not torch.equal(sa[k], sc[k])
        bound = 1.0 / np.sqrt(sa[k].shape[1])
        assert float(sa[k].abs().max()) <= bound
        assert float(sa[k].abs().max()) > 0.9 * bound
