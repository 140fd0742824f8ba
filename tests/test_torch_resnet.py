"""ModifiedResNet (vitlens_tpu_torch/models/resnet.py) against the JAX
package's on the CPU: open_clip-layout state dicts written from a seed by
tools/reference_layout.py, converted by both packages (the same tree) and
encoded by both (fp32, 1e-5 of the output's largest magnitude), at a small
arch and at RN50's widths with one block a stage; the attention pool alone
in bf16 through the kernel's plain version (cosine >= 0.999)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.reference_layout import modified_resnet_state_dict
from vitlens_tpu.models import resnet as JR
from vitlens_tpu_torch.models import resnet as PR
from vitlens_tpu_torch.weights.from_jax import flatten, load_params
from tests.test_torch_threads import share_cores

share_cores()

SMALL = dict(layers=(1, 2, 1, 1), width=16, image_size=64, embed_dim=24, heads=8)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


@pytest.mark.parametrize("arch_kw", [SMALL, dict(layers=(1, 1, 1, 1), width=64,
                                                 image_size=64, embed_dim=1024,
                                                 heads=32)])
def test_modified_resnet_matches_jax(arch_kw):
    arch = PR.ResNetArch(**arch_kw)
    ja = JR.ResNetArch(**dataclasses.asdict(arch))
    sd = modified_resnet_state_dict(arch, torch.Generator().manual_seed(0))
    want_tree = JR.convert_modified_resnet(sd, ja)
    tree = PR.convert_modified_resnet(sd, arch)
    fw, fg = flatten(want_tree), flatten(tree)
    assert sorted(fw) == sorted(fg)
    for k in fw:
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    m = PR.ModifiedResNet(arch)
    load_params(m, tree)
    x = np.random.RandomState(0).randn(2, 3, arch.image_size,
                                       arch.image_size).astype(np.float32)
    want = JR.modified_resnet_apply(want_tree, jnp.asarray(x), ja)
    got = m(torch.from_numpy(x))
    assert got.shape == (2, arch.embed_dim)
    assert _rel(got.detach().numpy(), want) < 1e-5


def test_attention_pool_bf16_and_entry_point(monkeypatch):
    """The pool in bf16 goes through ops.attention's kernel path (its plain
    version here) and holds cosine >= 0.999 against JAX's bf16 pool; the
    entry point raises without CUDA unless device='cpu'."""
    arch = PR.ResNetArch(**SMALL)
    sd = modified_resnet_state_dict(arch, torch.Generator().manual_seed(1))
    tree = PR.convert_modified_resnet(sd, arch)
    m = PR.ModifiedResNet(arch)
    load_params(m, tree)
    from vitlens_tpu_torch.ops import flash_attention as FA

    calls = []
    real = FA.flash_attention
    monkeypatch.setattr("vitlens_tpu_torch.ops.attention.flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    x = np.random.RandomState(1).randn(2, 512, 2, 2).astype(np.float32)
    got = m.attnpool(torch.from_numpy(x).bfloat16()).float().detach().numpy()
    want = JR.attention_pool2d_apply(jnp.asarray(x, jnp.bfloat16),
                                     JR.convert_modified_resnet(sd, JR.ResNetArch(
                                         **SMALL))["attnpool"], 8)
    want = np.asarray(want.astype(jnp.float32), np.float64)
    cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)
    assert calls == [torch.Size([2, 8, 5, 64])] and cos.min() >= 0.999
    small = PR.RESNET_ARCH_REGISTRY["RN50"]
    assert (small.width * 32, small.heads, (small.image_size // 32) ** 2 + 1) == (2048, 32, 50)
    monkeypatch.setattr(PR, "RESNET_ARCH_REGISTRY", {"RN50": arch})
    tower = PR.make_modified_resnet("RN50", device="cpu")
    assert tower(torch.zeros(1, 3, 64, 64)).shape == (1, 24)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PR.make_modified_resnet("RN50")
