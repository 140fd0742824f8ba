"""The vitlensG point-cloud tower's configuration (port of
``vitlens_tpu/train/openshape.py::vitlensG_tower_config``). The rest of the
OpenShape-triplet trainer (CLIPBind, its losses and eval) is not yet ported
(ROADMAP Queue 1, item 10); the config is what the vitlensG pc encode
needs.
"""

from __future__ import annotations

from vitlens_tpu_torch.config import (PerceiverConfig, PointAdapterConfig,
                                      TowerConfig, get_arch)


def vitlensG_tower_config() -> TowerConfig:
    """bigG Lens with the PNSA tokenizer, from the published vitlensG recipe
    (TRAIN_INFERENCE.md "Train vitlensG on OpenShape-Triplets"): pc
    in_channel 6, radius 0.2, npoints 10000, num_group 512, group_size 64,
    trans_dim 256; perceiver depth 4, latents 256, latent_dim 1664,
    cross/latent_dim_head 104, latent_heads 16; the first 16 of the 48 trunk
    blocks skipped. (JAX's copy also takes ``out_channel`` and
    ``skip_first_n_layers`` for its OpenShape trainer, not yet ported.)"""
    arch_entry = get_arch("ViT-bigG-14")
    arch = arch_entry["vision"]
    pt = PointAdapterConfig(tokenizer="pnsa", trans_dim=256, encoder_dims=256,
                            group_size=64, num_group=512, in_channel=6,
                            npoints=10000, radius=0.2)
    perc = PerceiverConfig(
        depth=4, num_latents=256, latent_dim=arch.width,
        input_dim=256, cross_heads=1, cross_dim_head=104,
        latent_heads=16, latent_dim_head=104,
        self_per_cross_attn=1,
    )
    return TowerConfig(
        arch=arch, embed_dim=arch_entry["embed_dim"], modality="pc",
        point=pt, perceiver=perc, skip_first_n_layers=16,
    )
