"""OpenShape point-cloud baseline encoders (port of
vitlens_tpu/models/pc_baselines.py).

The OpenShape trainer can swap the CLIPBind Lens tower for a comparison
baseline (reference VitLens-OpenShape/src/models/__init__.py:1-34):
PointBERT, which is the PointPatchTransformer (ppat.py:86-156), DGCNN
(dgcnn.py:67-135) and a plain PointNet (pointnet.py:5-21); the PointNet2 MSG
classifier (pointnet2.py:6-40) has no bind surface and is built directly.

Layout, as in JAX: xyz [B, N, 3] and features [B, N, C] channel-last; the
reference's pointwise Conv1d/Conv2d are products over the last axis
(``Linear``, weights [in, out]) followed by the port's ``BatchNorm`` in
batch-statistics (``train=True``, running statistics updated in place) or
eval mode. Module names follow the JAX trees, so ``weights/from_jax.py``
copies them: ``sa.mlp.{i}.conv``/``.bn``, ``sa1.branches.{i}.{j}``,
PPAT's per-block ``blocks.{i}.attn``/``.ff`` (stacked [depth, ...] in JAX),
DGCNN's ``conv{i}.conv``/``.bn``, PointNet's ``lift1``/``lift2``/``top``.

The point ops are ``ops/fps.py``'s, called through the module so that a
caller can observe them: ``fps_indices`` (the FPS kernel on CUDA),
``ball_query`` and ``knn_indices``. Those are always exact; JAX's
``knn_exact`` switch chooses its TPU approximations and is accepted here
and ignored. Every baseline runs in the dtype of its inputs (the trainer
gives fp32, as JAX's ``baseline_bind_apply`` does); PPAT's attention is
plain PyTorch, as JAX's is an einsum.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from vitlens_tpu_torch.adapters.tokenizers import BatchNorm
from vitlens_tpu_torch.models.layers import LayerNorm, Linear, _param, gelu, normal_
from vitlens_tpu_torch.ops import fps as P

Starts = Optional[Union[torch.Tensor, Sequence[torch.Tensor]]]


class ConvBN(nn.Module):
    """A pointwise conv (``conv``: w [in, out], optional bias) and its
    BatchNorm (``bn``)."""

    def __init__(self, c_in: int, c_out: int, bias: bool = True, device=None):
        super().__init__()
        self.conv = Linear(c_in, c_out, bias=bias, device=device)
        self.bn = BatchNorm(c_out, device=device)

    def init_(self, g: torch.Generator) -> None:
        self.conv.init_(g)  # torch Conv's kaiming_uniform on fan_in = in
        self.bn.init_(g)

    def forward(self, h: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.bn(self.conv(h), train=train)


def conv_stack(c_in: int, dims: Sequence[int], bias: bool = True,
               device=None) -> nn.ModuleList:
    out, last = nn.ModuleList(), c_in
    for d in dims:
        out.append(ConvBN(last, d, bias, device=device))
        last = d
    return out


def conv_stack_apply(stack: nn.ModuleList, h: torch.Tensor, train: bool,
                     act=torch.relu) -> torch.Tensor:
    for layer in stack:
        h = act(layer(h, train))
    return h


def _init_all(g: torch.Generator, *modules) -> None:
    for m in modules:
        if isinstance(m, nn.ModuleList):
            _init_all(g, *m)
        else:
            m.init_(g)


# ---------------------------------------------------------------------------
# PointNet++ set abstraction (single-scale, MSG, group-all).
# Reference: pointnet_util.py:171-274
# ---------------------------------------------------------------------------


class SetAbstraction(nn.Module):
    """PointNetSetAbstraction (``sa_init``/``sa_apply``)."""

    def __init__(self, in_channel: int, mlp: Sequence[int], device=None):
        super().__init__()
        self.mlp = conv_stack(in_channel, mlp, device=device)

    def init_(self, g: torch.Generator) -> None:
        _init_all(g, self.mlp)

    def forward(self, xyz, points, *, npoint: Optional[int],
                radius: Optional[float], nsample: Optional[int],
                group_all: bool, train: bool = False,
                fps_start: Optional[torch.Tensor] = None,
                fps_generator: Optional[torch.Generator] = None,
                knn_exact=None):
        """(new_xyz [B, S, 3], feat [B, S, C']). Single-scale grouping puts
        the centred xyz first and the points after (pointnet_util.py:139-
        143); group-all puts xyz first (:150-168)."""
        del knn_exact  # always exact (module docstring)
        B = xyz.shape[0]
        if group_all:
            new_xyz = xyz.new_zeros((B, 1, 3))
            grouped = xyz[:, None]
            if points is not None:
                grouped = torch.cat([grouped, points[:, None]], -1)
        else:
            idx_fps = P.fps_indices(xyz.contiguous(), npoint, start=fps_start,
                                    generator=fps_generator)
            new_xyz = P.take_points(xyz, idx_fps)
            idx = P.ball_query(xyz, new_xyz, radius, nsample)
            grouped = P.take_points(xyz, idx) - new_xyz[:, :, None, :]
            if points is not None:
                grouped = torch.cat([grouped, P.take_points(points, idx)], -1)
        h = conv_stack_apply(self.mlp, grouped, train)
        return new_xyz, h.amax(dim=2)


class SetAbstractionMsg(nn.Module):
    """PointNetSetAbstractionMsg (``sa_msg_init``/``sa_msg_apply``): one
    FPS, then a ball query and a conv stack a radius."""

    def __init__(self, in_channel: int, mlp_list: Sequence[Sequence[int]],
                 device=None):
        super().__init__()
        self.branches = nn.ModuleList(
            conv_stack(in_channel + 3, mlp, device=device) for mlp in mlp_list)

    def init_(self, g: torch.Generator) -> None:
        _init_all(g, *self.branches)

    def forward(self, xyz, points, *, npoint: int,
                radius_list: Sequence[float], nsample_list: Sequence[int],
                train: bool = False, fps_start: Optional[torch.Tensor] = None,
                fps_generator: Optional[torch.Generator] = None,
                knn_exact=None):
        """MSG puts the points first and the centred xyz second
        (pointnet_util.py:259), the opposite of single-scale grouping."""
        del knn_exact
        idx_fps = P.fps_indices(xyz.contiguous(), npoint, start=fps_start,
                                generator=fps_generator)
        new_xyz = P.take_points(xyz, idx_fps)
        feats = []
        for branch, radius, k in zip(self.branches, radius_list, nsample_list):
            idx = P.ball_query(xyz, new_xyz, radius, k)
            grouped = P.take_points(xyz, idx) - new_xyz[:, :, None, :]
            if points is not None:
                grouped = torch.cat([P.take_points(points, idx), grouped], -1)
            feats.append(conv_stack_apply(branch, grouped, train).amax(dim=2))
        return new_xyz, torch.cat(feats, -1)


# ---------------------------------------------------------------------------
# PPAT, the PointBERT baseline. Reference ppat.py:86-156
# ---------------------------------------------------------------------------

# dim, depth, heads, mlp_dim, sa_dim, patches, prad, nsamp (ppat.py:126-156)
PPAT_SCALINGS = {
    1: dict(dim=256, depth=6, heads=4, mlp_dim=1024, sa_dim=96,
            patches=64, prad=0.4, nsamp=256),
    2: dict(dim=512, depth=6, heads=8, mlp_dim=1024, sa_dim=128,
            patches=64, prad=0.4, nsamp=256),
    3: dict(dim=512, depth=12, heads=8, mlp_dim=1024, sa_dim=128,
            patches=128, prad=0.35, nsamp=128),
    4: dict(dim=512, depth=12, heads=8, mlp_dim=512 * 3, sa_dim=256,
            patches=384, prad=0.2, nsamp=64),
    5: dict(dim=768, depth=12, heads=12, mlp_dim=768 * 3, sa_dim=256,
            patches=512, prad=0.2, nsamp=64),
    6: dict(dim=768, depth=24, heads=12, mlp_dim=768 * 4, sa_dim=256,
            patches=512, prad=0.2, nsamp=64),
}
PPAT_DIM_HEAD = 64  # ppat.py:30 dim_head default, never overridden


class _Normed(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.ln = LayerNorm(dim, device=device)


class PPATLayer(nn.Module):
    """One pre-norm block: ``attn`` (ln, bias-free qkv, out) and ``ff`` (ln,
    fc, GELU, proj)."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, device=None):
        super().__init__()
        inner = heads * PPAT_DIM_HEAD
        self.heads = heads
        self.attn = _Normed(dim, device=device)
        self.attn.qkv = Linear(dim, 3 * inner, bias=False, device=device)
        self.attn.out = Linear(inner, dim, device=device)
        self.ff = _Normed(dim, device=device)
        self.ff.fc = Linear(dim, mlp_dim, device=device)
        self.ff.proj = Linear(mlp_dim, dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        _init_all(g, self.attn.ln, self.attn.qkv, self.attn.out, self.ff.ln,
                  self.ff.fc, self.ff.proj)

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        """ppat.py:29-64 Attention (rel_pe off in every shipped scaling),
        plain: the scores are scaled after the product, as in JAX."""
        B, n, _ = x.shape
        q, k, v = (t.reshape(B, n, self.heads, PPAT_DIM_HEAD).transpose(1, 2)
                   for t in self.attn.qkv(x).chunk(3, dim=-1))
        dots = (q @ k.transpose(-1, -2)) * (PPAT_DIM_HEAD ** -0.5)
        o = torch.softmax(dots, dim=-1) @ v
        return self.attn.out(o.transpose(1, 2).reshape(B, n, -1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x + self.attention(self.attn.ln(x))
        ff = self.ff
        return h + ff.proj(gelu(ff.fc(ff.ln(h))))


class PointPatchTransformer(nn.Module):
    """PointPatchTransformer + its Projected head (``ppat_init`` /
    ``ppat_apply``): a set abstraction to ``patches`` centers, the lift
    ([center ; feature] -> dim, LayerNorm), a CLS token, ``depth`` blocks
    and ``proj`` of the CLS output."""

    def __init__(self, scaling: int, in_channel: int = 3,
                 out_channel: int = 1280, device=None):
        super().__init__()
        cfg = self.cfg = PPAT_SCALINGS[scaling]
        self.sa = SetAbstraction(in_channel + 3, [64, 64, cfg["sa_dim"]],
                                 device=device)
        self.lift = nn.Module()
        self.lift.conv = Linear(cfg["sa_dim"] + 3, cfg["dim"], device=device)
        self.lift.ln = LayerNorm(cfg["dim"], device=device)
        self.cls_token = _param(cfg["dim"], device=device)
        self.blocks = nn.ModuleList(
            PPATLayer(cfg["dim"], cfg["heads"], cfg["mlp_dim"], device=device)
            for _ in range(cfg["depth"]))
        self.proj = Linear(cfg["dim"], out_channel, device=device)

    def init_(self, g: torch.Generator) -> None:
        _init_all(g, self.sa, self.lift.conv, self.lift.ln, self.blocks,
                  self.proj)
        normal_(self.cls_token, 1.0, g)

    def forward(self, xyz, features, train: bool = False,
                patch_dropout: int = 0,
                fps_start: Optional[torch.Tensor] = None,
                fps_generator: Optional[torch.Generator] = None,
                knn_exact=None) -> torch.Tensor:
        """xyz [B, N, 3], features [B, N, in_channel] -> [B, out_channel].
        Train-time patch dropout takes ``patch_dropout`` fewer centers
        (ppat.py:101-103)."""
        cfg = self.cfg
        npoint = cfg["patches"] - (patch_dropout if train else 0)
        centroids, feat = self.sa(
            xyz, features, npoint=npoint, radius=cfg["prad"],
            nsample=cfg["nsamp"], group_all=False, train=train,
            fps_start=fps_start, fps_generator=fps_generator,
            knn_exact=knn_exact)
        x = self.lift.ln(self.lift.conv(
            torch.cat([centroids.to(feat.dtype), feat], -1)))
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
        for block in self.blocks:
            x = block(x)
        return self.proj(x[:, 0])


# ---------------------------------------------------------------------------
# DGCNN. Reference dgcnn.py:11-135
# ---------------------------------------------------------------------------


def graph_feature(x: torch.Tensor, k: int) -> torch.Tensor:
    """get_graph_feature (dgcnn.py:14-39), channel-last: x [B, N, C] ->
    [B, N, k, 2C] = [neighbour - x ; x] over the k nearest neighbours in
    feature space, the point itself included."""
    neigh = P.take_points(x, P.knn_indices(x, x, k))
    center = x[:, :, None, :].expand_as(neigh)
    return torch.cat([neigh - center, center], dim=-1)


class DGCNN(nn.Module):
    """DGCNN (``dgcnn_init``/``dgcnn_apply``) at base width
    ``int(64 * scaling)``: four edge convs on kNN graphs of the previous
    layer's features (bias-free, BatchNorm, LeakyReLU 0.2, max over the
    neighbours), conv5 over their concatenation, max and mean pooling,
    linear1 + bn6 + LeakyReLU, linear2."""

    def __init__(self, in_channel: int = 3, out_channel: int = 256,
                 scaling: float = 1, k: int = 20, device=None):
        super().__init__()
        self.k = k
        base = int(64 * scaling)
        dims = [(in_channel * 2, base), (base * 2, base), (base * 2, base * 2),
                (base * 4, base * 4), (base * 8, base * 16)]
        for i, (c_in, c_out) in enumerate(dims, 1):
            setattr(self, f"conv{i}", ConvBN(c_in, c_out, bias=False,
                                             device=device))
        self.linear1 = Linear(base * 32, base * 8, bias=False, device=device)
        self.bn6 = BatchNorm(base * 8, device=device)
        self.linear2 = Linear(base * 8, out_channel, device=device)

    def init_(self, g: torch.Generator) -> None:
        _init_all(g, *(getattr(self, f"conv{i}") for i in range(1, 6)),
                  self.linear1, self.bn6, self.linear2)

    def forward(self, xyz, features, train: bool = False,
                knn_exact=None) -> torch.Tensor:
        """features [B, N, in_channel] -> [B, out_channel] (xyz unused, as
        in the reference's forward)."""
        del xyz, knn_exact

        def leaky(t):
            return F.leaky_relu(t, 0.2)

        x, feats = features, []
        for i in range(1, 5):
            h = getattr(self, f"conv{i}")(graph_feature(x, self.k), train)
            x = leaky(h).amax(dim=2)
            feats.append(x)
        h = leaky(self.conv5(torch.cat(feats, dim=-1), train))
        pooled = torch.cat([h.amax(dim=1), h.mean(dim=1)], -1)
        h = self.bn6(self.linear1(pooled), train=train)
        return self.linear2(leaky(h))


# ---------------------------------------------------------------------------
# PointNet2 MSG classifier. Reference pointnet2.py:6-40
# ---------------------------------------------------------------------------


class PointNet2(nn.Module):
    """get_model (``pointnet2_init``/``pointnet2_apply``): two MSG set
    abstractions (512, then 128 centers), a group-all one, and the
    fc1/bn1/fc2/bn2/fc3 classifier."""

    def __init__(self, num_class: int, normal_channel: bool = True,
                 device=None):
        super().__init__()
        self.normal_channel = normal_channel
        in_ch = 3 if normal_channel else 0
        self.sa1 = SetAbstractionMsg(
            in_ch, [[32, 32, 64], [64, 64, 128], [64, 96, 128]], device=device)
        self.sa2 = SetAbstractionMsg(
            320, [[64, 64, 128], [128, 128, 256], [128, 128, 256]],
            device=device)
        self.sa3 = SetAbstraction(640 + 3, [256, 512, 1024], device=device)
        self.fc1 = Linear(1024, 512, device=device)
        self.fc2 = Linear(512, 256, device=device)
        self.fc3 = Linear(256, num_class, device=device)
        self.bn1 = BatchNorm(512, device=device)
        self.bn2 = BatchNorm(256, device=device)

    def init_(self, g: torch.Generator) -> None:
        _init_all(g, self.sa1, self.sa2, self.sa3, self.fc1, self.fc2,
                  self.fc3, self.bn1, self.bn2)

    def forward(self, xyz, train: bool = False, fps_start: Starts = None,
                fps_generator: Optional[torch.Generator] = None,
                knn_exact=None):
        """xyz [B, N, 3 (+3 normals)] -> (log-softmax logits [B,
        num_class], the l3 feature [B, 1024]). ``fps_start`` is one [B]
        tensor for both MSG levels (as JAX passes one ``fps_start``, and
        one ``fps_key``, to both) or a pair, one a level (the starts JAX
        draws from its key at N and at 512); with ``fps_generator`` each
        level draws its own."""
        pts = xyz[..., 3:] if self.normal_channel else None
        coords = xyz[..., :3]
        s1, s2 = (fps_start if isinstance(fps_start, (tuple, list))
                  else (fps_start, fps_start))
        kw = dict(train=train, fps_generator=fps_generator, knn_exact=knn_exact)
        l1_xyz, l1 = self.sa1(coords, pts, npoint=512,
                              radius_list=[0.1, 0.2, 0.4],
                              nsample_list=[16, 32, 128], fps_start=s1, **kw)
        l2_xyz, l2 = self.sa2(l1_xyz, l1, npoint=128,
                              radius_list=[0.2, 0.4, 0.8],
                              nsample_list=[32, 64, 128], fps_start=s2, **kw)
        _, l3 = self.sa3(l2_xyz, l2, npoint=None, radius=None, nsample=None,
                         group_all=True, train=train)
        h = l3[:, 0]
        h = torch.relu(self.bn1(self.fc1(h), train=train))
        h = torch.relu(self.bn2(self.fc2(h), train=train))
        return torch.log_softmax(self.fc3(h), dim=-1), l3[:, 0]


# ---------------------------------------------------------------------------
# Plain PointNet. Reference pointnet.py:5-21 (torch_redstone MLP stages:
# pointwise linear + BatchNorm + ReLU each)
# ---------------------------------------------------------------------------


class PointNet(nn.Module):
    """``pointnet_init``/``pointnet_apply``: lift1 (64, 64) and lift2 (64s,
    128s, 1024s) over the points, a global max pool, top (512s), head."""

    def __init__(self, in_channel: int = 3, out_channel: int = 1280,
                 scaling: int = 1, device=None):
        super().__init__()
        s = scaling
        self.lift1 = conv_stack(in_channel, [64, 64], device=device)
        self.lift2 = conv_stack(64, [64 * s, 128 * s, 1024 * s], device=device)
        self.top = conv_stack(1024 * s, [512 * s], device=device)
        self.head = Linear(512 * s, out_channel, device=device)

    def init_(self, g: torch.Generator) -> None:
        _init_all(g, self.lift1, self.lift2, self.top, self.head)

    def forward(self, xyz, features, train: bool = False) -> torch.Tensor:
        del xyz
        h = conv_stack_apply(self.lift1, features, train)
        h = conv_stack_apply(self.lift2, h, train).amax(dim=1)
        return self.head(conv_stack_apply(self.top, h, train))


# ---------------------------------------------------------------------------
# Factory mirroring reference models/__init__.py::make
# ---------------------------------------------------------------------------


def make_pc_baseline(name: str, *, in_channel: int = 6,
                     out_channel: int = 1280, scaling: int = 3,
                     device=None) -> nn.Module:
    """The baseline ``name`` as a module (uninitialised: call ``init_(g)`` or
    load weights), forward ``(xyz, features, train=False, ...) ->
    [B, out_channel]``. ``PointBERT`` is the PPAT; PointNet2, Minkowski,
    PointNeXt and PointMLP raise, as in JAX."""
    if name == "PointBERT":
        return PointPatchTransformer(scaling, in_channel, out_channel,
                                     device=device)
    if name == "DGCNN":
        return DGCNN(in_channel, out_channel, scaling, device=device)
    if name == "PointNet":
        return PointNet(in_channel, out_channel, scaling, device=device)
    if name == "PointNet2":
        # The reference trainer's make() has no PointNet2 branch either
        # (models/__init__.py:4-34): pointnet2.py is a ModelNet classifier.
        raise NotImplementedError(
            "PointNet2 is a classification baseline (pointnet2_apply), not "
            "a contrastive encoder — the reference trainer cannot bind it "
            "either (models/__init__.py:4-34).")
    raise NotImplementedError(
        f"pc baseline {name!r} not supported. Minkowski is disabled in the "
        "reference itself; PointNeXt/PointMLP wrap a git submodule the "
        "reference does not vendor.")
