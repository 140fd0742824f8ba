"""PointTransformer: the PointBERT point-cloud classifier/encoder (port of
vitlens_tpu/models/point_transformer.py).

    FPS + kNN groups -> mini-PointNet -> reduce_dim -> [CLS; tokens], with
    [cls_pos; MLP(center)] added before every block -> LayerNorm ->
    [CLS ; max over tokens] (do_cat) -> @ proj

(reference modal_3d/models/pointbert/point_encoder.py:170-295). The
tokenizer is the port's ``PointTokenizer`` (the point-encoder kernel in a
bf16 eval pass); the blocks are the shared pre-LN ``ResBlock`` with exact
GELU and a zero qkv bias (the reference's qkv has none), so a bf16 pass runs
the fused MLP and attention kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
import torch.nn as nn

from vitlens_tpu_torch.adapters.tokenizers import PointTokenizer
from vitlens_tpu_torch.config import PointAdapterConfig
from vitlens_tpu_torch.models.layers import (LayerNorm, Transformer, _param,
                                             normal_)
from vitlens_tpu_torch.weights.torch_convert import (  # noqa: F401  (JAX's API)
    convert_point_transformer)


@dataclass(frozen=True)
class PointTransformerConfig:
    point: PointAdapterConfig = field(default_factory=PointAdapterConfig)
    depth: int = 12
    num_heads: int = 6
    do_cat: bool = True
    output_dim: Optional[int] = None


class PointTransformer(nn.Module):
    """``point_transformer_init`` / ``point_transformer_apply``. Parameter
    names follow the JAX tree: ``tokenizer.*``, ``cls_token``, ``cls_pos``,
    ``blocks.blocks.{i}.*``, ``norm`` and, with ``output_dim``, ``proj``."""

    def __init__(self, cfg: PointTransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.point.trans_dim
        self.tokenizer = PointTokenizer(cfg.point, device=device)
        self.cls_token = _param(d, device=device)
        self.cls_pos = _param(d, device=device)
        self.blocks = Transformer(d, cfg.depth, cfg.num_heads, device=device)
        self.norm = LayerNorm(d, device=device)
        cat = 2 if cfg.do_cat else 1
        self.proj = (_param(cat * d, cfg.output_dim, device=device)
                     if cfg.output_dim is not None else None)

    def init_(self, g: torch.Generator) -> None:
        self.tokenizer.init_(g)
        with torch.no_grad():
            self.cls_token.zero_()
        normal_(self.cls_pos, 1.0, g)
        self.blocks.init_(g)
        self.norm.init_(g)
        if self.proj is not None:
            normal_(self.proj, self.cfg.output_dim ** -0.5, g)

    def forward(self, pts: torch.Tensor, *, train: bool = False,
                fps_start: Optional[torch.Tensor] = None,
                fps_generator: Optional[torch.Generator] = None,
                compute_dtype=torch.float32) -> torch.Tensor:
        """pts [B, N, 3] -> [B, output_dim] (or [B, cat * trans_dim]). FPS
        starts at ``fps_start``, or draws from ``fps_generator``, or starts
        at point 0 (JAX's ``fps_key``: given, or None)."""
        pts = pts.to(compute_dtype)
        tokens, pos = self.tokenizer(pts, train, fps_start, fps_generator)
        B, _, d = tokens.shape
        cls = self.cls_token.to(tokens.dtype).expand(B, 1, d)
        cls_pos = self.cls_pos.to(tokens.dtype).expand(B, 1, d)
        x = torch.cat([cls, tokens], dim=1)
        pos_full = torch.cat([cls_pos, pos], dim=1)
        for block in self.blocks.blocks:
            x = block(x + pos_full)  # the reference re-adds pos every block
        x = self.norm(x)
        feat = (torch.cat([x[:, 0], x[:, 1:].amax(dim=1)], dim=-1)
                if self.cfg.do_cat else x[:, 0])
        if self.proj is not None:
            feat = feat @ self.proj.to(feat.dtype)
        return feat


def label_smoothing_loss(pred: torch.Tensor, gt: torch.Tensor,
                         eps: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """PointTransformer.get_loss_acc (point_encoder.py:221-238): the
    label-smoothed cross entropy (fp32) and the accuracy in percent."""
    n_class = pred.shape[1]
    logp = torch.log_softmax(pred.float(), dim=1)
    one_hot = torch.nn.functional.one_hot(gt.long(), n_class).float()
    smooth = one_hot * (1 - eps) + (1 - one_hot) * eps / (n_class - 1)
    loss = -(smooth * logp).sum(dim=1).mean()
    acc = (pred.argmax(dim=-1) == gt).float().mean() * 100
    return loss, acc
