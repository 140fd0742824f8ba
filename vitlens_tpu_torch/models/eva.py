"""EVA ViT-g trunk and the Perceiver-EVA Lens tower, the vitlensG MLLM
plug-in (port of vitlens_tpu/models/eva.py).

  * EVA blocks are the pre-LN resblocks of ``models/layers.py`` with
    LayerNorm eps 1e-6, which reaches the fused-MLP kernel too; the qkv bias
    pattern [q_bias, 0, v_bias] lives in ``qkv_b`` (the converter writes the
    zero k bias).
  * The trunk: a patch embedding (or tokens given), CLS, the absolute
    positions (resized bicubically, as ``jax.image.resize`` does, when the
    token count differs), the blocks, the final LayerNorm, CLS pooling and
    the head (1408 -> 1024).
  * The tower: modality adapter -> Perceiver -> EVA trunk on the latents ->
    head. ``skip_first_n`` keeps the last blocks. The head is drawn anew
    when the trunk's ``proj_dim`` differs from the tower's ``embed_dim``.

At full width (``perceiver_eva_tower_config("pc")``) one bf16 encode
launches the fused MLP 39 times (D 1408, H 6144), attention 47 times (39 in
the trunk at head dim 88, 4 Lens cross and 4 Lens self), FPS once and the
point encoder once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from vitlens_tpu_torch.adapters.tokenizers import patchify_2d
from vitlens_tpu_torch.config import TowerConfig
from vitlens_tpu_torch.models.layers import (LayerNorm, Linear, Transformer,
                                             _param, normal_)
from vitlens_tpu_torch.models.perceiver import Perceiver
from vitlens_tpu_torch.models.vit import adapter_tokens, make_adapter

EVA_LN_EPS = 1e-6


@dataclass(frozen=True)
class EVAArch:
    """create_eva_vit_g's defaults."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1408
    layers: int = 39
    head_width: int = 88
    mlp_ratio: float = 4.3637
    proj_dim: int = 1024

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def num_patches(self) -> int:
        g = self.image_size // self.patch_size
        return g * g


def resize_pos(pos: torch.Tensor, target: int) -> torch.Tensor:
    """[1 + g*g, D] -> [target, D]: CLS kept, the grid resized as
    ``jax.image.resize(..., "bicubic")`` does (Keys' cubic with a = -0.5,
    antialiased when shrinking), in float64, returned in pos's dtype."""
    from vitlens_tpu_torch.weights.torch_convert import _cubic_weights

    n = pos.shape[0] - 1
    g_old = int(round(n ** 0.5))
    g_new = int(round((target - 1) ** 0.5))
    w = torch.from_numpy(_cubic_weights(g_old, g_new)).to(pos.device)
    grid = pos[1:].double().reshape(g_old, g_old, -1)
    resized = torch.einsum("hwd,hi,wj->ijd", grid, w, w)
    return torch.cat([pos[:1], resized.reshape(g_new * g_new, -1).to(pos.dtype)], 0)


class EVATrunk(nn.Module):
    """Parameter names as the JAX tree's: ``patch_embed.{w,b}``,
    ``cls_token``, ``pos_embed``, ``trunk.blocks.<i>``, ``norm``,
    ``head.{w,b}``."""

    def __init__(self, arch: EVAArch, head_dim: Optional[int] = None,
                 device=None):
        super().__init__()
        self.arch = arch
        w = arch.width
        self.patch_embed = Linear(3 * arch.patch_size ** 2, w, device=device)
        self.cls_token = _param(w, device=device)
        self.pos_embed = _param(arch.num_patches + 1, w, device=device)
        self.trunk = Transformer(w, arch.layers, arch.heads, arch.mlp_ratio,
                                 device=device, ln_eps=EVA_LN_EPS)
        self.norm = LayerNorm(w, EVA_LN_EPS, device=device)
        self.head = Linear(w, head_dim or arch.proj_dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        normal_(self.patch_embed.w, 0.02, g)
        normal_(self.cls_token, 0.02, g)
        normal_(self.pos_embed, 0.02, g)
        self.trunk.init_(g)
        self.norm.init_(g)
        normal_(self.head.w, 0.02, g)
        with torch.no_grad():
            self.patch_embed.b.zero_()
            self.head.b.zero_()

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32, *,
                tokens_input: bool = False, use_pos_embed: bool = True,
                skip_first_n: Optional[int] = None, apply_head: bool = True,
                remat=False) -> torch.Tensor:
        """Images [B, 3, H, W] (or tokens [B, N, width] with
        ``tokens_input``) -> pooled [B, head dim] ([B, width] without the
        head). ``skip_first_n`` keeps the last (layers - n) blocks."""
        x = x.to(compute_dtype)
        if not tokens_input:
            x = self.patch_embed(patchify_2d(x, self.arch.patch_size))
        B, _, width = x.shape
        cls = self.cls_token.to(x.dtype).expand(B, 1, width)
        h = torch.cat([cls, x], dim=1)
        if use_pos_embed:
            pos = self.pos_embed
            if pos.shape[0] != h.shape[1]:
                pos = resize_pos(pos, h.shape[1])
            h = h + pos.to(h.dtype)
        h = self.trunk(h, skip_first_n=skip_first_n, remat=remat)
        pooled = self.norm(h)[:, 0]
        return self.head(pooled) if apply_head else pooled


def perceiver_eva_tower_config(modality: str = "pc", **tower_kw) -> TowerConfig:
    """The adapter and Perceiver half's config: the modality's standard
    adapter retargeted at width 1408, 256 latents (the EVA grid)."""
    from vitlens_tpu_torch.config import make_tower_config

    return make_tower_config("EVA-g-14", modality, **tower_kw)


class PerceiverEVATower(nn.Module):
    """adapter (+ its positions) -> Perceiver -> EVA trunk on the latents ->
    head: inputs -> [B, embed_dim]."""

    def __init__(self, tower: TowerConfig, eva_arch: EVAArch = EVAArch(),
                 embed_dim: int = 1024, device=None):
        super().__init__()
        self.cfg, self.eva_arch, self.embed_dim = tower, eva_arch, embed_dim
        self.adapter = make_adapter(tower, device)
        p = tower.perceiver
        self.perceiver = (Perceiver(p, device=device)
                          if p is not None and not p.as_identity else None)
        self.eva = EVATrunk(eva_arch, head_dim=embed_dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        self.adapter.init_(g)
        if self.perceiver is not None:
            self.perceiver.init_(g)
        self.eva.init_(g)
        if self.eva_arch.proj_dim != self.embed_dim:
            # the reference's eva_vit_proj when the head does not fit
            normal_(self.eva.head.w, self.eva_arch.width ** -0.5, g)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32, *,
                skip_first_n_layers: Optional[int] = None,
                use_orig_pos: bool = True, train: bool = False, remat=False,
                fps_start: Optional[torch.Tensor] = None,
                fps_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens = adapter_tokens(self.adapter, self.cfg, x, compute_dtype, train,
                                fps_start, fps_generator)
        if self.perceiver is not None:
            tokens = self.perceiver(tokens)
        return self.eva(tokens, compute_dtype, tokens_input=True,
                        use_pos_embed=use_orig_pos,
                        skip_first_n=skip_first_n_layers, remat=remat)


def make_eva_tower(modality: str = "pc", *, device=None, seed: int = 0,
                   dtype: torch.dtype = torch.float32,
                   eva_arch: EVAArch = EVAArch(),
                   embed_dim: int = 1024) -> PerceiverEVATower:
    """The full-width Perceiver-EVA tower of ``modality`` on ``device`` (the
    CUDA device unless given), drawn from a generator seeded with ``seed``,
    its matmul weights cast to ``dtype``."""
    from vitlens_tpu_torch.factory import (cast_matmul_weights_, make_generator,
                                           resolve_device)

    device = resolve_device(device)
    tower = PerceiverEVATower(perceiver_eva_tower_config(modality), eva_arch,
                              embed_dim, device=device)
    tower.init_(make_generator(seed, device))
    return cast_matmul_weights_(tower, dtype)


def convert_eva_state_dict(sd: Mapping[str, Any], arch: EVAArch) -> Dict[str, Any]:
    """BLIP-2 ``eva_vit_g.pth`` keys (``blocks.N.{norm1, attn.qkv,
    attn.q_bias, attn.v_bias, attn.proj, norm2, mlp.fc1, mlp.fc2}``,
    ``patch_embed.proj``, ``cls_token``, ``pos_embed``, ``norm``, ``head``)
    -> the JAX tree layout (blocks stacked); without ``head.*`` the head is
    the identity."""
    from vitlens_tpu_torch.weights.torch_convert import _j, _linear, _ln, _stack

    blocks = []
    for i in range(arch.layers):
        pre = f"blocks.{i}."
        q_b, v_b = _j(sd[f"{pre}attn.q_bias"]), _j(sd[f"{pre}attn.v_bias"])
        blocks.append({
            "ln_1": _ln(sd, f"{pre}norm1"),
            "attn": {
                "qkv_w": np.ascontiguousarray(_j(sd[f"{pre}attn.qkv.weight"]).T),
                "qkv_b": np.concatenate([q_b, np.zeros_like(q_b), v_b]),
                "out_w": np.ascontiguousarray(_j(sd[f"{pre}attn.proj.weight"]).T),
                "out_b": _j(sd[f"{pre}attn.proj.bias"]),
            },
            "ln_2": _ln(sd, f"{pre}norm2"),
            "mlp": {"fc": _linear(sd, f"{pre}mlp.fc1"),
                    "proj": _linear(sd, f"{pre}mlp.fc2")},
        })
    pe_w = _j(sd["patch_embed.proj.weight"])  # [W, 3, p, p]
    p: Dict[str, Any] = {
        "patch_embed": {"w": np.ascontiguousarray(pe_w.reshape(pe_w.shape[0], -1).T),
                        "b": _j(sd["patch_embed.proj.bias"])},
        "cls_token": _j(sd["cls_token"]).reshape(-1),
        "pos_embed": _j(sd["pos_embed"]).reshape(-1, arch.width),
        "trunk": {"blocks": _stack(blocks)},
        "norm": _ln(sd, "norm"),
    }
    if "head.weight" in sd:
        p["head"] = _linear(sd, "head")
    else:
        p["head"] = {"w": np.eye(arch.width, dtype=np.float32),
                     "b": np.zeros((arch.width,), np.float32)}
    return p
