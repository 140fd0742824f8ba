"""ModifiedResNet CLIP image tower (port of vitlens_tpu/models/resnet.py).

A 3-conv stem with an avgpool, 4 bottleneck stages whose downsample is
avgpool -> 1x1 conv, and the AttentionPool2d head (the mean token as the
query's row, learned positions, separate q/k/v projections). Kept for
open_clip compatibility; no ViT-Lens result uses it.

The convolutions and the BatchNorms (inference, from running statistics:
the towers are frozen) are plain PyTorch, as the JAX package leaves them to
XLA; the pool's unmasked attention goes through ``ops.attention`` (the
kernel in bf16 on CUDA: [B, 32, 50, 50, 64] at RN50). Parameter names are
the JAX tree's (``bn*.{scale, bias, mean, var}`` are all parameters there,
frozen), so ``weights/from_jax.py`` copies it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vitlens_tpu_torch.models.layers import Linear, _param, normal_
from vitlens_tpu_torch.ops.attention import dot_product_attention

BN_EPS = 1e-5


@dataclass(frozen=True)
class ResNetArch:
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    width: int = 64
    image_size: int = 224
    embed_dim: int = 1024
    heads: int = 32  # attn-pool heads = width * 32 // 64


class Conv(nn.Module):
    def __init__(self, n_in: int, n_out: int, k: int, device=None):
        super().__init__()
        self.w = _param(n_out, n_in, k, k, device=device)

    def init_(self, g: torch.Generator) -> None:
        normal_(self.w, (self.w[0].numel()) ** -0.5, g)

    def forward(self, x, stride: int = 1, padding: int = 0):
        return F.conv2d(x, self.w.to(x.dtype), stride=stride, padding=padding)


class FrozenBN(nn.Module):
    """[B, C, H, W] BatchNorm from running statistics."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        for n in ("scale", "bias", "mean", "var"):
            setattr(self, n, _param(dim, device=device))

    def init_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        rstd = torch.rsqrt(self.var.float() + BN_EPS)
        scale = (self.scale.float() * rstd).to(x.dtype)
        bias = (self.bias.float() - self.mean.float() * self.scale.float() * rstd
                ).to(x.dtype)
        return x * scale[None, :, None, None] + bias[None, :, None, None]


def _avgpool2(x):
    return F.avg_pool2d(x, 2)


class Downsample(nn.Module):
    def __init__(self, n_in: int, n_out: int, device=None):
        super().__init__()
        self.conv = Conv(n_in, n_out, 1, device=device)
        self.bn = FrozenBN(n_out, device=device)


class Bottleneck(nn.Module):
    """conv1 (1x1)-bn-relu, conv2 (3x3)-bn-relu, [avgpool if stride > 1],
    conv3 (1x1)-bn, + the identity (avgpool -> 1x1 conv -> bn where it
    downsamples), relu."""

    def __init__(self, inplanes: int, planes: int, stride: int, device=None):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = Conv(inplanes, planes, 1, device), FrozenBN(planes, device)
        self.conv2, self.bn2 = Conv(planes, planes, 3, device), FrozenBN(planes, device)
        self.conv3 = Conv(planes, planes * 4, 1, device)
        self.bn3 = FrozenBN(planes * 4, device)
        self.downsample = (Downsample(inplanes, planes * 4, device)
                           if stride > 1 or inplanes != planes * 4 else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out, padding=1)))
        if self.stride > 1:
            out = _avgpool2(out)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample is not None:
            identity = x if self.stride == 1 else _avgpool2(x)
            identity = self.downsample.bn(self.downsample.conv(identity))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    def __init__(self, grid: int, embed: int, heads: int, out_dim: int,
                 device=None):
        super().__init__()
        self.heads = heads
        self.positional_embedding = _param(grid * grid + 1, embed, device=device)
        for n in ("q_proj", "k_proj", "v_proj"):
            setattr(self, n, Linear(embed, embed, device=device))
        self.c_proj = Linear(embed, out_dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        embed = self.positional_embedding.shape[1]
        normal_(self.positional_embedding, embed ** -0.5, g)
        for lin in (self.q_proj, self.k_proj, self.v_proj, self.c_proj):
            normal_(lin.w, embed ** -0.5, g)
            with torch.no_grad():
                lin.b.zero_()

    def forward(self, x):
        """[B, C, H, W] -> [B, out_dim]: HW flattened, the mean token
        prepended, + positions, unmasked MHA, the mean token's output."""
        B, C, H, W = x.shape
        t = x.reshape(B, C, H * W).transpose(1, 2)
        t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1)
        t = t + self.positional_embedding.to(t.dtype)[None]
        N, dh = t.shape[1], C // self.heads

        def sh(z):
            return z.reshape(B, N, self.heads, dh).transpose(1, 2)

        o = dot_product_attention(sh(self.q_proj(t)), sh(self.k_proj(t)),
                                  sh(self.v_proj(t)))
        o = self.c_proj(o.transpose(1, 2).reshape(B, N, C))
        return o[:, 0]


class ModifiedResNet(nn.Module):
    def __init__(self, arch: ResNetArch, device=None):
        super().__init__()
        self.arch = arch
        w = arch.width
        self.conv1, self.bn1 = Conv(3, w // 2, 3, device), FrozenBN(w // 2, device)
        self.conv2, self.bn2 = Conv(w // 2, w // 2, 3, device), FrozenBN(w // 2, device)
        self.conv3, self.bn3 = Conv(w // 2, w, 3, device), FrozenBN(w, device)
        self.layers = nn.ModuleList()
        inplanes = w
        for li, n_blocks in enumerate(arch.layers):
            planes = w * 2 ** li
            stage = nn.ModuleList()
            for bi in range(n_blocks):
                stride = (1 if li == 0 else 2) if bi == 0 else 1
                stage.append(Bottleneck(inplanes, planes, stride, device))
                inplanes = planes * 4
            self.layers.append(stage)
        self.attnpool = AttentionPool2d(arch.image_size // 32, w * 32, arch.heads,
                                        arch.embed_dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (Conv, FrozenBN)):
                m.init_(g)
        self.attnpool.init_(g)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """[B, 3, H, W] -> [B, embed_dim]."""
        x = x.to(compute_dtype)
        x = F.relu(self.bn1(self.conv1(x, 2, 1)))
        x = F.relu(self.bn2(self.conv2(x, 1, 1)))
        x = F.relu(self.bn3(self.conv3(x, 1, 1)))
        x = _avgpool2(x)
        for stage in self.layers:
            for block in stage:
                x = block(x)
        return self.attnpool(x)


# the reference model_configs/RN*.json
RESNET_ARCH_REGISTRY = {
    "RN50": ResNetArch(layers=(3, 4, 6, 3), width=64, image_size=224,
                       embed_dim=1024, heads=32),
    "RN101": ResNetArch(layers=(3, 4, 23, 3), width=64, image_size=224,
                        embed_dim=512, heads=32),
    "RN50x4": ResNetArch(layers=(4, 6, 10, 6), width=80, image_size=288,
                         embed_dim=640, heads=40),
    "RN50x16": ResNetArch(layers=(6, 8, 18, 8), width=96, image_size=384,
                          embed_dim=768, heads=48),
    "RN50x64": ResNetArch(layers=(3, 15, 36, 10), width=128, image_size=448,
                          embed_dim=1024, heads=64),
}


def make_modified_resnet(name: str = "RN50", *, device=None, seed: int = 0,
                         dtype: torch.dtype = torch.float32) -> ModifiedResNet:
    """The ``name`` tower on ``device`` (the CUDA device unless given), drawn
    from a generator seeded with ``seed``, its convolution and matmul
    weights cast to ``dtype``."""
    from vitlens_tpu_torch.factory import (cast_matmul_weights_, make_generator,
                                           resolve_device)

    device = resolve_device(device)
    m = ModifiedResNet(RESNET_ARCH_REGISTRY[name], device=device)
    m.init_(make_generator(seed, device))
    return cast_matmul_weights_(m, dtype)


def convert_modified_resnet(sd: Mapping[str, Any], arch: ResNetArch) -> Dict[str, Any]:
    """An open_clip ModifiedResNet state dict -> the JAX tree layout (convs
    kept OIHW, Linear weights transposed to [in, out])."""
    from vitlens_tpu_torch.weights.torch_convert import _j, _linear

    def bn(name):
        return {"scale": _j(sd[f"{name}.weight"]), "bias": _j(sd[f"{name}.bias"]),
                "mean": _j(sd[f"{name}.running_mean"]),
                "var": _j(sd[f"{name}.running_var"])}

    def conv(name):
        return {"w": _j(sd[f"{name}.weight"])}

    p: Dict[str, Any] = {"conv1": conv("conv1"), "bn1": bn("bn1"),
                         "conv2": conv("conv2"), "bn2": bn("bn2"),
                         "conv3": conv("conv3"), "bn3": bn("bn3"), "layers": []}
    for li, n_blocks in enumerate(arch.layers):
        blocks = []
        for bi in range(n_blocks):
            pre = f"layer{li + 1}.{bi}."
            bp = {"conv1": conv(pre + "conv1"), "bn1": bn(pre + "bn1"),
                  "conv2": conv(pre + "conv2"), "bn2": bn(pre + "bn2"),
                  "conv3": conv(pre + "conv3"), "bn3": bn(pre + "bn3")}
            # the reference downsample: ("-1" avgpool, "0" conv, "1" bn)
            if f"{pre}downsample.0.weight" in sd:
                bp["downsample"] = {"conv": conv(pre + "downsample.0"),
                                    "bn": bn(pre + "downsample.1")}
            blocks.append(bp)
        p["layers"].append(blocks)
    p["attnpool"] = {"positional_embedding": _j(sd["attnpool.positional_embedding"]),
                     **{n: _linear(sd, f"attnpool.{n}")
                        for n in ("q_proj", "k_proj", "v_proj", "c_proj")}}
    return p

