"""Typed configuration tree, copied field for field from vitlens_tpu/config.py.

The JAX package's module is itself jax-free, but importing anything under
``vitlens_tpu`` runs that package's ``__init__``, which imports jax; so the
port keeps its own copy. tests/test_torch_config.py holds the two equal for
every arch and modality.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

ModalityType = SimpleNamespace(
    IMAGE="image",
    VIDEO="video",
    TEXT="text",
    AUDIO="audio",
    DEPTH="depth",
    EEG="eeg",
    TACTILE="tactile",
    PC="pc",
)

ALL_VISUAL_MODALITIES = ("image", "video", "audio", "depth", "eeg", "tactile", "pc")

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)


# ---------------------------------------------------------------------------
# Tower architecture configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VisionArch:
    """CLIP ViT trunk architecture (reference: model_configs/*.json vision_cfg)."""

    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    head_width: int = 64
    mlp_ratio: float = 4.0
    ls_init_value: Optional[float] = None
    global_average_pool: bool = False

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid(self) -> Tuple[int, int]:
        g = self.image_size // self.patch_size
        return (g, g)

    @property
    def num_patches(self) -> int:
        g0, g1 = self.grid
        return g0 * g1


@dataclass(frozen=True)
class TextArch:
    """CLIP text tower architecture (reference: model_configs/*.json text_cfg).

    When `hf_style` is set, the text tower is the TPU-native BERT-family
    encoder (models/bert_text.py — the reference builds HFTextEncoder from
    text_cfg.hf_model_name, model.py _build_text_tower + hf_model.py) with
    width/heads/layers/vocab_size reused as hidden/heads/layers/vocab."""

    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    ls_init_value: Optional[float] = None
    hf_style: Optional[str] = None      # None | "bert" | "roberta"
    hf_pooler_type: str = "mean_pooler"
    hf_proj: str = "mlp"
    hf_intermediate: int = 3072
    hf_max_positions: int = 514
    hf_pad_id: int = 1
    hf_tokenizer_name: Optional[str] = None  # recorded for data pipelines


@dataclass(frozen=True)
class PerceiverConfig:
    """Perceiver "Lens" config (reference: open_clip/perceiver.py:157-332 and
    module_cfg.py:37-58)."""

    depth: int = 1
    num_latents: int = 256
    latent_dim: int = 1024
    input_dim: int = 1024
    cross_heads: int = 1
    cross_dim_head: int = 64
    latent_heads: int = 16
    latent_dim_head: int = 64
    self_per_cross_attn: int = 1
    ff_mult: int = 4
    weight_tie_layers: bool = False
    fourier_encode_data: bool = False
    num_freq_bands: int = 32
    max_freq: float = 10.0
    input_axis: int = 1
    # Dispatch flags (reference: perceiver.py:369-401 get_perceiver modes)
    as_identity: bool = False
    as_transformer: bool = False


@dataclass(frozen=True)
class PointAdapterConfig:
    """PointBERT-style tokenizer config (reference: modal_3d pointbert
    point_encoder.py:299-362, dvae.py:143-212)."""

    tokenizer: str = "pointbert"  # or "pnsa"
    npoints: int = 8192
    num_group: int = 512
    group_size: int = 32
    encoder_dims: int = 256
    trans_dim: int = 384
    in_channel: int = 3
    radius: float = 0.2  # pnsa ball-query radius
    # kNN exactness: None = auto (approx_min_k on TPU @ recall 0.99,
    # exact top_k elsewhere); True forces reference-exact neighbours
    knn_exact: Optional[bool] = None


@dataclass(frozen=True)
class AudioAdapterConfig:
    """AST-style audio tokenizer (reference: modal_audio/models/AST_tokenizer.py)."""

    mel_bins: int = 128
    target_length: int = 512
    fstride: int = 10
    tstride: int = 10
    patch_size: int = 16
    clip_duration: float = 5.0
    sampling_rate: int = 16000
    n_clip: int = 3

    @property
    def fdim(self) -> int:
        return (self.mel_bins - self.patch_size) // self.fstride + 1

    @property
    def tdim(self) -> int:
        return (self.target_length - self.patch_size) // self.tstride + 1

    @property
    def num_patches(self) -> int:
        return self.fdim * self.tdim


@dataclass(frozen=True)
class EEGAdapterConfig:
    """1-D patch embed for EEG (reference: modal_eeg/models/EEG_tokenizer.py)."""

    chans: int = 128
    time_len: int = 512
    window_size: int = 1
    stride: int = 1

    @property
    def num_patches(self) -> int:
        return (self.time_len - self.window_size) // self.stride + 1


@dataclass(frozen=True)
class VideoAdapterConfig:
    """Video frame path (reference transformer.py:472-490, 679-712):
    per-frame image patch embed + learned temporal position (ltpos).
    The fpos (Fourier) option is dead code in the reference — its import
    target open_clip.perceiver_io does not exist in the repo."""

    n_frames: int = 8
    use_ltpos: bool = True
    distill_tokens: bool = False  # vid_distill_tokens loss plumbing


@dataclass(frozen=True)
class TowerConfig:
    """One Lens/vision tower: trunk + optional adapter + optional perceiver.

    Mirrors the reference CLIPVisionCfg ViT-Lens fields
    (model.py:34-79: visual_modality_type, use_perceiver, perceiver_cfg,
    use_visual_adapter, visual_adapter_cfg)."""

    arch: VisionArch = field(default_factory=VisionArch)
    embed_dim: int = 512
    modality: str = "image"  # visual_modality_type
    quick_gelu: bool = False
    perceiver: Optional[PerceiverConfig] = None
    point: Optional[PointAdapterConfig] = None
    audio: Optional[AudioAdapterConfig] = None
    eeg: Optional[EEGAdapterConfig] = None
    video: Optional[VideoAdapterConfig] = None
    use_adapter_pos: bool = True  # not disable_visual_adapter_pos
    use_orig_pos: bool = True  # not disable_orig_pos
    skip_first_n_layers: Optional[int] = None  # skip_trans_first_n_layers
    # train-time patch dropout (reference PatchDropout transformer.py:53-90,
    # applied at :770-771; --force-patch-dropout factory.py:228-230).
    # 0.0 = disabled; inference always bypasses it.
    patch_dropout: float = 0.0

    @property
    def num_tokens(self) -> int:
        """Sequence length entering the ViT trunk (without CLS)."""
        if self.perceiver is not None and not (
            self.perceiver.as_identity or self.perceiver.as_transformer
        ):
            return self.perceiver.num_latents
        if self.perceiver is not None:
            # identity/transformer perceiver: pos-emb still sized by num_latents
            # (reference transformer.py:497-516)
            return self.perceiver.num_latents
        return self.arch.num_patches

    @property
    def adapter_num_tokens(self) -> int:
        """Token count produced by the modality adapter (perceiver input)."""
        if self.modality in ("image", "tactile"):
            return self.arch.num_patches
        if self.modality == "video":
            return self.video.n_frames * self.arch.num_patches
        if self.modality == "pc":
            return self.point.num_group
        if self.modality == "audio":
            return self.audio.num_patches
        if self.modality == "depth":
            return self.arch.num_patches
        if self.modality == "eeg":
            return self.eeg.num_patches
        raise ValueError(self.modality)


@dataclass(frozen=True)
class ModelConfig:
    """Full tri-tower model (reference TriCLIP, model.py:391-622)."""

    name: str = "ViT-L-14"
    embed_dim: int = 768
    vision: VisionArch = field(default_factory=VisionArch)
    text: TextArch = field(default_factory=TextArch)
    tower: TowerConfig = field(default_factory=TowerConfig)  # the Lens tower
    quick_gelu: bool = False
    init_logit_scale_inv_temp: float = 0.07  # logit_scale = ln(1/0.07)


# ---------------------------------------------------------------------------
# Arch registry (reference: open_clip/model_configs/*.json)
# ---------------------------------------------------------------------------

ARCH_REGISTRY: Dict[str, Dict[str, Any]] = {
    "ViT-B-16": dict(
        embed_dim=512,
        vision=VisionArch(image_size=224, patch_size=16, width=768, layers=12),
        text=TextArch(width=512, heads=8, layers=12),
    ),
    "ViT-B-32": dict(
        embed_dim=512,
        vision=VisionArch(image_size=224, patch_size=32, width=768, layers=12),
        text=TextArch(width=512, heads=8, layers=12),
    ),
    "ViT-L-14": dict(
        embed_dim=768,
        vision=VisionArch(image_size=224, patch_size=14, width=1024, layers=24),
        text=TextArch(width=768, heads=12, layers=12),
    ),
    # remaining open_clip ViT family (reference model_configs/*.json, exact
    # transcriptions; resolution variants serve the resize_pos_embed path)
    "ViT-S-16": dict(
        embed_dim=384,
        vision=VisionArch(image_size=224, patch_size=16, width=384, layers=12),
        text=TextArch(width=384, heads=6, layers=12),
    ),
    "ViT-S-32": dict(
        embed_dim=384,
        vision=VisionArch(image_size=224, patch_size=32, width=384, layers=12),
        text=TextArch(width=384, heads=6, layers=12),
    ),
    "ViT-M-16": dict(
        embed_dim=512,
        vision=VisionArch(image_size=224, patch_size=16, width=512, layers=12),
        text=TextArch(width=512, heads=8, layers=12),
    ),
    "ViT-M-32": dict(
        embed_dim=512,
        vision=VisionArch(image_size=224, patch_size=32, width=512, layers=12),
        text=TextArch(width=512, heads=8, layers=12),
    ),
    "ViT-B-16-plus": dict(
        embed_dim=640,
        vision=VisionArch(image_size=224, patch_size=16, width=896, layers=12),
        text=TextArch(width=640, heads=10, layers=12),
    ),
    "ViT-B-16-plus-240": dict(
        embed_dim=640,
        vision=VisionArch(image_size=240, patch_size=16, width=896, layers=12),
        text=TextArch(width=640, heads=10, layers=12),
    ),
    "ViT-B-32-plus-256": dict(
        embed_dim=640,
        vision=VisionArch(image_size=256, patch_size=32, width=896, layers=12),
        text=TextArch(width=640, heads=10, layers=12),
    ),
    "ViT-L-14-280": dict(
        embed_dim=768,
        vision=VisionArch(image_size=280, patch_size=14, width=1024, layers=24),
        text=TextArch(width=768, heads=12, layers=12),
    ),
    "ViT-L-14-336": dict(
        embed_dim=768,
        vision=VisionArch(image_size=336, patch_size=14, width=1024, layers=24),
        text=TextArch(width=768, heads=12, layers=12),
    ),
    "ViT-L-16": dict(
        embed_dim=768,
        vision=VisionArch(image_size=224, patch_size=16, width=1024, layers=24),
        text=TextArch(width=768, heads=12, layers=12),
    ),
    "ViT-L-16-320": dict(
        embed_dim=768,
        vision=VisionArch(image_size=320, patch_size=16, width=1024, layers=24),
        text=TextArch(width=768, heads=12, layers=12),
    ),
    "ViT-H-16": dict(
        embed_dim=1024,
        vision=VisionArch(image_size=224, patch_size=16, width=1280, layers=32,
                          head_width=80),
        text=TextArch(width=1024, heads=16, layers=24),
    ),
    "ViT-g-14": dict(
        embed_dim=1024,
        vision=VisionArch(image_size=224, patch_size=14, width=1408, layers=40,
                          head_width=88, mlp_ratio=4.3637),
        text=TextArch(width=1024, heads=16, layers=24),
    ),
    "ViT-e-14": dict(
        embed_dim=1280,
        vision=VisionArch(image_size=224, patch_size=14, width=1792, layers=56,
                          head_width=112, mlp_ratio=8.5715),
        text=TextArch(width=1280, heads=20, layers=36),
    ),
    "ViT-H-14": dict(
        embed_dim=1024,
        vision=VisionArch(image_size=224, patch_size=14, width=1280, layers=32, head_width=80),
        text=TextArch(width=1024, heads=16, layers=24),
    ),
    "ViT-bigG-14": dict(
        embed_dim=1280,
        vision=VisionArch(
            image_size=224, patch_size=14, width=1664, layers=48,
            head_width=104, mlp_ratio=4.9231,
        ),
        text=TextArch(width=1280, heads=20, layers=32),
    ),
    # tiny arch for smoke tests / CI (not a reference model)
    "ViT-Tiny-Test": dict(
        embed_dim=32,
        vision=VisionArch(image_size=28, patch_size=14, width=64, layers=2,
                          head_width=32),
        text=TextArch(context_length=77, vocab_size=49408, width=64, heads=2,
                      layers=2),
    ),
    # EVA ViT-g trunk used by the vitlensG MLLM plug-in
    # (reference: third_vit/blip_eva_vit.py:763-800 create_eva_vit_g)
    "EVA-g-14": dict(
        embed_dim=1024,
        vision=VisionArch(
            image_size=224, patch_size=14, width=1408, layers=39,
            head_width=88, mlp_ratio=4.3637,
        ),
        text=TextArch(width=1024, heads=16, layers=24),
    ),
    # HF-text CLIP family (reference model_configs/{roberta-ViT-B-32,
    # xlm-roberta-base-ViT-B-32, xlm-roberta-large-ViT-H-14}.json): the text
    # tower is the TPU-native BERT-family encoder (models/bert_text.py)
    # configured from the named HF arch; mean_pooler + mlp proj per the
    # reference text_cfg. roberta-ViT-B-32.json sets quick_gelu: true; the
    # entry carries it so the builders default to QuickGELU for this arch.
    "roberta-ViT-B-32": dict(
        embed_dim=512,
        quick_gelu=True,
        vision=VisionArch(image_size=224, patch_size=32, width=768,
                          layers=12),
        text=TextArch(width=768, heads=12, layers=12, vocab_size=50265,
                      hf_style="roberta", hf_intermediate=3072,
                      hf_max_positions=514, hf_pad_id=1,
                      hf_tokenizer_name="roberta-base"),
    ),
    "xlm-roberta-base-ViT-B-32": dict(
        embed_dim=512,
        vision=VisionArch(image_size=224, patch_size=32, width=768,
                          layers=12),
        text=TextArch(width=768, heads=12, layers=12, vocab_size=250002,
                      hf_style="roberta", hf_intermediate=3072,
                      hf_max_positions=514, hf_pad_id=1,
                      hf_tokenizer_name="xlm-roberta-base"),
    ),
    "xlm-roberta-large-ViT-H-14": dict(
        embed_dim=1024,
        vision=VisionArch(image_size=224, patch_size=14, width=1280,
                          layers=32, head_width=80),
        text=TextArch(width=1024, heads=16, layers=24, vocab_size=250002,
                      hf_style="roberta", hf_intermediate=4096,
                      hf_max_positions=514, hf_pad_id=1,
                      hf_tokenizer_name="xlm-roberta-large"),
    ),
}


def get_arch(name: str) -> Dict[str, Any]:
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


# ---------------------------------------------------------------------------
# vitlensL presets (reference: mm_vit_lens/model_cfg.py:80-182)
# ---------------------------------------------------------------------------


def _lens_perceiver(arch: VisionArch, **kw) -> PerceiverConfig:
    """Per-trunk perceiver defaults: latents match the trunk grid, latent dim
    matches the trunk width (vitlensL table mm_vit_lens/model_cfg.py:80-182;
    vitlensB values in perceiver.py:427-445 comments follow the same rule)."""
    base = dict(
        num_latents=arch.num_patches, latent_dim=arch.width, input_dim=arch.width,
        cross_heads=1, cross_dim_head=64,
        latent_heads=max(arch.width // 64, 1), latent_dim_head=64,
        fourier_encode_data=False, weight_tie_layers=False,
    )
    base.update(kw)
    return PerceiverConfig(**base)


def make_tower_config(
    model: str = "ViT-L-14",
    modality: str = "image",
    *,
    quick_gelu: bool = False,
    **overrides: Any,
) -> TowerConfig:
    """Build a TowerConfig for `modality` on trunk `model`.

    Per-modality defaults follow the vitlensL table
    (reference mm_vit_lens/model_cfg.py:80-182)."""
    arch_entry = get_arch(model)
    arch: VisionArch = arch_entry["vision"]
    embed_dim: int = arch_entry["embed_dim"]
    # some archs bake quick_gelu into their reference json (e.g.
    # roberta-ViT-B-32.json "quick_gelu": true) — honor the registry default
    quick_gelu = quick_gelu or arch_entry.get("quick_gelu", False)

    kw: Dict[str, Any] = dict(
        arch=arch, embed_dim=embed_dim, modality=modality, quick_gelu=quick_gelu
    )
    if modality in ("image", "tactile"):
        pass  # plain patch-embed path, no adapter/perceiver
    elif modality == "video":
        kw["video"] = VideoAdapterConfig()
        kw["perceiver"] = _lens_perceiver(arch, depth=2, self_per_cross_attn=1)
    elif modality == "pc":
        pt = PointAdapterConfig()
        kw["point"] = pt
        kw["perceiver"] = _lens_perceiver(
            arch, depth=4, input_dim=pt.trans_dim, self_per_cross_attn=1
        )
    elif modality == "audio":
        kw["audio"] = AudioAdapterConfig()
        kw["perceiver"] = _lens_perceiver(arch, depth=2, self_per_cross_attn=3)
    elif modality == "depth":
        kw["perceiver"] = _lens_perceiver(arch, depth=1, as_identity=True)
    elif modality == "eeg":
        kw["eeg"] = EEGAdapterConfig()
        kw["perceiver"] = _lens_perceiver(arch, depth=1, self_per_cross_attn=1)
    else:
        raise ValueError(f"unknown modality {modality!r}")

    for k, v in overrides.items():
        kw[k] = v
    return TowerConfig(**kw)


def make_model_config(
    model: str = "ViT-L-14",
    modality: str = "image",
    *,
    quick_gelu: bool = False,
    force_image_size: Optional[int] = None,
    **tower_overrides: Any,
) -> ModelConfig:
    """force_image_size: run the trunk at a different resolution (reference
    --force-image-size; pos-emb converter resizes grid->grid bicubic)."""
    arch_entry = get_arch(model)
    quick_gelu = quick_gelu or arch_entry.get("quick_gelu", False)
    vision = arch_entry["vision"]
    if force_image_size is not None:
        vision = replace(vision, image_size=force_image_size)
    tower = make_tower_config(model, modality, quick_gelu=quick_gelu,
                              **dict(tower_overrides))
    if force_image_size is not None:
        tower = replace(tower, arch=vision)
        # a cross-attending perceiver keeps its canonical latent count
        # regardless of input resolution (the reference's explicit 256), but
        # identity/transformer perceivers pass tokens through — their
        # "latent" count (which sizes the trunk pos-emb) must track the
        # forced grid or the pos-emb add breaks
        if tower.perceiver is not None and (tower.perceiver.as_identity
                                            or tower.perceiver.as_transformer):
            tower = replace(tower, perceiver=replace(
                tower.perceiver, num_latents=tower.adapter_num_tokens))
    return ModelConfig(
        name=model,
        embed_dim=arch_entry["embed_dim"],
        vision=vision,
        text=arch_entry["text"],
        tower=tower,
        quick_gelu=quick_gelu,
    )


def image_tower_config(model_cfg: ModelConfig) -> TowerConfig:
    """The frozen CLIP image tower paired with a Lens tower
    (reference: module_cfg.py set_default_image_cfg)."""
    return TowerConfig(
        arch=model_cfg.vision,
        embed_dim=model_cfg.embed_dim,
        modality="image",
        quick_gelu=model_cfg.quick_gelu,
    )


def asdict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


__all__ = [
    "ModalityType",
    "VisionArch",
    "TextArch",
    "PerceiverConfig",
    "PointAdapterConfig",
    "AudioAdapterConfig",
    "EEGAdapterConfig",
    "TowerConfig",
    "ModelConfig",
    "ARCH_REGISTRY",
    "get_arch",
    "make_tower_config",
    "make_model_config",
    "image_tower_config",
    "replace",
]
