"""Pretrained tags and checkpoint publishing (port of vitlens_tpu/utils/hub.py).

The registry of pretrained tags (reference pretrained.py), the cache
directory and :func:`resolve_pretrained`, which turns a tag into the path of
its file in the local cache. The port downloads nothing: a tag whose file is
not in the cache raises, naming the path to put it at. :func:`push_to_hf_hub`
publishes a tower's parameters through ``huggingface_hub``, which it imports
when called.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

# Pretrained tag registry (reference pretrained.py:24-398). Stored as
# (hf repo, filename) or url; resolution order: local cache dir, then hub.
# Carries every tag reachable by an architecture this build implements
# (ViT family + ModifiedResNet + EVA-g); HF-text / roberta / convnext / coca
# tags are out of scope (those towers back no ViT-Lens result).
_OPENAI_CLIP = "https://openaipublic.azureedge.net/clip/models"
PRETRAINED_REGISTRY: Dict[str, Dict[str, Any]] = {
    # --- CLIP trunks used by ViT-Lens recipes (pretrained.py:94-245) ---
    "ViT-L-14/datacomp_xl_s13b_b90k": dict(  # the vitlensL trunk
        hf_hub="laion/CLIP-ViT-L-14-DataComp.XL-s13B-b90K/",
        quick_gelu=False),
    "ViT-L-14/openai": dict(
        url=f"{_OPENAI_CLIP}/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
        quick_gelu=True),
    "ViT-L-14/laion400m_e31": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_l_14-laion400m_e31-69988bb6.pt",
        quick_gelu=False),
    "ViT-L-14/laion400m_e32": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_l_14-laion400m_e32-3d133497.pt",
        quick_gelu=False),
    "ViT-L-14/laion2b_s32b_b82k": dict(
        hf_hub="laion/CLIP-ViT-L-14-laion2B-s32B-b82K/", quick_gelu=False,
        mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
    "ViT-L-14/commonpool_xl_clip_s13b_b90k": dict(
        hf_hub="laion/CLIP-ViT-L-14-CommonPool.XL.clip-s13B-b90K/",
        quick_gelu=False),
    "ViT-L-14/commonpool_xl_laion_s13b_b90k": dict(
        hf_hub="laion/CLIP-ViT-L-14-CommonPool.XL.laion-s13B-b90K/",
        quick_gelu=False),
    "ViT-L-14/commonpool_xl_s13b_b90k": dict(
        hf_hub="laion/CLIP-ViT-L-14-CommonPool.XL-s13B-b90K/",
        quick_gelu=False),
    "ViT-L-14-336/openai": dict(
        url=f"{_OPENAI_CLIP}/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
        quick_gelu=True),
    "ViT-B-16/openai": dict(
        url=f"{_OPENAI_CLIP}/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
        quick_gelu=True),
    "ViT-B-16/laion400m_e31": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_16-laion400m_e31-00efa78f.pt",
        quick_gelu=False),
    "ViT-B-16/laion400m_e32": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_16-laion400m_e32-55e67d44.pt",
        quick_gelu=False),
    "ViT-B-16/laion2b_s34b_b88k": dict(
        hf_hub="laion/CLIP-ViT-B-16-laion2B-s34B-b88K/", quick_gelu=False),
    "ViT-B-16/datacomp_l_s1b_b8k": dict(
        hf_hub="laion/CLIP-ViT-B-16-DataComp.L-s1B-b8K/", quick_gelu=False),
    "ViT-B-32/openai": dict(
        url=f"{_OPENAI_CLIP}/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
        quick_gelu=True),
    "ViT-B-32/laion2b_s34b_b79k": dict(
        hf_hub="laion/CLIP-ViT-B-32-laion2B-s34B-b79K/", quick_gelu=False),
    "ViT-B-32/datacomp_m_s128m_b4k": dict(
        hf_hub="laion/CLIP-ViT-B-32-DataComp.M-s128M-b4K/", quick_gelu=False),
    "ViT-H-14/laion2b_s32b_b79k": dict(
        hf_hub="laion/CLIP-ViT-H-14-laion2B-s32B-b79K/", quick_gelu=False),
    "ViT-g-14/laion2b_s12b_b42k": dict(
        hf_hub="laion/CLIP-ViT-g-14-laion2B-s12B-b42K/", quick_gelu=False),
    "ViT-g-14/laion2b_s34b_b88k": dict(
        hf_hub="laion/CLIP-ViT-g-14-laion2B-s34B-b88K/", quick_gelu=False),
    "ViT-bigG-14/laion2b_s39b_b160k": dict(  # the vitlensG trunk
        hf_hub="laion/CLIP-ViT-bigG-14-laion2B-39B-b160k/", quick_gelu=False),
    "RN50/openai": dict(
        url=f"{_OPENAI_CLIP}/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
        quick_gelu=True),
    "RN101/openai": dict(
        url=f"{_OPENAI_CLIP}/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
        quick_gelu=True),
    # --- remaining reference registry tags (pretrained.py:24-398):
    # RN family -> models/resnet.py; ViT-B variants; roberta/xlm CLIP
    # (text via models/bert_text.py); CoCa -> models/coca.py
    # (make_coca; no converter for the released CoCa files, as in the JAX
    # package). convnext tags are NOT carried (timm tower absent from this
    # image). ---
    "RN50/yfcc15m": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/rn50-quickgelu-yfcc15m-455df137.pt",
        quick_gelu=True),
    "RN50/cc12m": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/rn50-quickgelu-cc12m-f000538c.pt",
        quick_gelu=True),
    "RN50-quickgelu/openai": dict(
        url="https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
        quick_gelu=True),
    "RN50-quickgelu/yfcc15m": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/rn50-quickgelu-yfcc15m-455df137.pt",
        quick_gelu=True),
    "RN50-quickgelu/cc12m": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/rn50-quickgelu-cc12m-f000538c.pt",
        quick_gelu=True),
    "RN101/yfcc15m": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/rn101-quickgelu-yfcc15m-3e04b30e.pt",
        quick_gelu=True),
    "RN101-quickgelu/openai": dict(
        url="https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
        quick_gelu=True),
    "RN101-quickgelu/yfcc15m": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/rn101-quickgelu-yfcc15m-3e04b30e.pt",
        quick_gelu=True),
    "RN50x4/openai": dict(
        url="https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
        quick_gelu=True),
    "RN50x16/openai": dict(
        url="https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
        quick_gelu=True),
    "RN50x64/openai": dict(
        url="https://openaipublic.azureedge.net/clip/models/be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt",
        quick_gelu=True),
    "ViT-B-32/laion400m_e31": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_32-quickgelu-laion400m_e31-d867053b.pt",
        quick_gelu=True),
    "ViT-B-32/laion400m_e32": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_32-quickgelu-laion400m_e32-46683a32.pt",
        quick_gelu=True),
    "ViT-B-32/laion2b_e16": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_32-laion2b_e16-af8dbd0c.pth",
        quick_gelu=False),
    "ViT-B-32-quickgelu/openai": dict(
        url="https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
        quick_gelu=True),
    "ViT-B-32-quickgelu/laion400m_e31": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_32-quickgelu-laion400m_e31-d867053b.pt",
        quick_gelu=True),
    "ViT-B-32-quickgelu/laion400m_e32": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_32-quickgelu-laion400m_e32-46683a32.pt",
        quick_gelu=True),
    "ViT-B-32/commonpool_m_clip_s128m_b4k": dict(
        hf_hub="laion/CLIP-ViT-B-32-CommonPool.M.clip-s128M-b4K/", quick_gelu=False),
    "ViT-B-32/commonpool_s_clip_s13m_b4k": dict(
        hf_hub="laion/CLIP-ViT-B-32-CommonPool.S.clip-s13M-b4K/", quick_gelu=False),
    "ViT-B-16/commonpool_l_clip_s1b_b8k": dict(
        hf_hub="laion/CLIP-ViT-B-16-CommonPool.L.clip-s1B-b8K/", quick_gelu=False),
    "ViT-B-32/commonpool_m_laion_s128m_b4k": dict(
        hf_hub="laion/CLIP-ViT-B-32-CommonPool.M.laion-s128M-b4K/", quick_gelu=False),
    "ViT-B-32/commonpool_s_laion_s13m_b4k": dict(
        hf_hub="laion/CLIP-ViT-B-32-CommonPool.S.laion-s13M-b4K/", quick_gelu=False),
    "ViT-B-16/commonpool_l_laion_s1b_b8k": dict(
        hf_hub="laion/CLIP-ViT-B-16-CommonPool.L.laion-s1B-b8K/", quick_gelu=False),
    "ViT-B-32/commonpool_m_image_s128m_b4k": dict(
        hf_hub="laion/CLIP-ViT-B-32-CommonPool.M.image-s128M-b4K/", quick_gelu=False),
    "ViT-B-32/commonpool_s_image_s13m_b4k": dict(
        hf_hub="laion/CLIP-ViT-B-32-CommonPool.S.image-s13M-b4K/", quick_gelu=False),
    "ViT-B-16/commonpool_l_image_s1b_b8k": dict(
        hf_hub="laion/CLIP-ViT-B-16-CommonPool.L.image-s1B-b8K/", quick_gelu=False),
    "ViT-B-32/commonpool_m_text_s128m_b4k": dict(
        hf_hub="laion/CLIP-ViT-B-32-CommonPool.M.text-s128M-b4K/", quick_gelu=False),
    "ViT-B-32/commonpool_s_text_s13m_b4k": dict(
        hf_hub="laion/CLIP-ViT-B-32-CommonPool.S.text-s13M-b4K/", quick_gelu=False),
    "ViT-B-16/commonpool_l_text_s1b_b8k": dict(
        hf_hub="laion/CLIP-ViT-B-16-CommonPool.L.text-s1B-b8K/", quick_gelu=False),
    "ViT-B-32/commonpool_m_basic_s128m_b4k": dict(
        hf_hub="laion/CLIP-ViT-B-32-CommonPool.M.basic-s128M-b4K/", quick_gelu=False),
    "ViT-B-32/commonpool_s_basic_s13m_b4k": dict(
        hf_hub="laion/CLIP-ViT-B-32-CommonPool.S.basic-s13M-b4K/", quick_gelu=False),
    "ViT-B-16/commonpool_l_basic_s1b_b8k": dict(
        hf_hub="laion/CLIP-ViT-B-16-CommonPool.L.basic-s1B-b8K/", quick_gelu=False),
    "ViT-B-32/commonpool_m_s128m_b4k": dict(
        hf_hub="laion/CLIP-ViT-B-32-CommonPool.M-s128M-b4K/", quick_gelu=False),
    "ViT-B-32/commonpool_s_s13m_b4k": dict(
        hf_hub="laion/CLIP-ViT-B-32-CommonPool.S-s13M-b4K/", quick_gelu=False),
    "ViT-B-16/commonpool_l_s1b_b8k": dict(
        hf_hub="laion/CLIP-ViT-B-16-CommonPool.L-s1B-b8K/", quick_gelu=False),
    "ViT-B-32/datacomp_s_s13m_b4k": dict(
        hf_hub="laion/CLIP-ViT-B-32-DataComp.S-s13M-b4K/", quick_gelu=False),
    "ViT-B-16-plus-240/laion400m_e31": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_16_plus_240-laion400m_e31-8fb26589.pt",
        quick_gelu=False),
    "ViT-B-16-plus-240/laion400m_e32": dict(
        url="https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_16_plus_240-laion400m_e32-699c4b84.pt",
        quick_gelu=False),
    "roberta-ViT-B-32/laion2b_s12b_b32k": dict(
        hf_hub="laion/CLIP-ViT-B-32-roberta-base-laion2B-s12B-b32k/", quick_gelu=False),
    "xlm-roberta-base-ViT-B-32/laion5b_s13b_b90k": dict(
        hf_hub="laion/CLIP-ViT-B-32-xlm-roberta-base-laion5B-s13B-b90k/", quick_gelu=False),
    "xlm-roberta-large-ViT-H-14/frozen_laion5b_s13b_b90k": dict(
        hf_hub="laion/CLIP-ViT-H-14-frozen-xlm-roberta-large-laion5B-s13B-b90k/", quick_gelu=False),
    "coca_ViT-B-32/laion2b_s13b_b90k": dict(
        hf_hub="laion/CoCa-ViT-B-32-laion2B-s13B-b90k/", quick_gelu=False),
    "coca_ViT-B-32/mscoco_finetuned_laion2b_s13b_b90k": dict(
        hf_hub="laion/mscoco_finetuned_CoCa-ViT-B-32-laion2B-s13B-b90k/", quick_gelu=False),
    "coca_ViT-L-14/laion2b_s13b_b90k": dict(
        hf_hub="laion/CoCa-ViT-L-14-laion2B-s13B-b90k/", quick_gelu=False),
    "coca_ViT-L-14/mscoco_finetuned_laion2b_s13b_b90k": dict(
        hf_hub="laion/mscoco_finetuned_CoCa-ViT-L-14-laion2B-s13B-b90k/", quick_gelu=False),
    # --- released ViT-Lens checkpoints (MODEL_ZOO.md; HF TencentARC/ViT-Lens) ---
    "vitlensL": dict(hf_hub="TencentARC/ViT-Lens/vitlensL.pt"),
    "vitlensL_pc": dict(hf_hub="TencentARC/ViT-Lens/vitlensL_pc.pt"),
    "vitlensL_pc_shapenet": dict(
        hf_hub="TencentARC/ViT-Lens/vitlensL_pc_shapenet.pt"),
    "vitlensL_audio": dict(hf_hub="TencentARC/ViT-Lens/vitlensL_audio.pt"),
    "vitlensL_audio_2s": dict(
        hf_hub="TencentARC/ViT-Lens/vitlensL_audio_2s.pt"),
    "vitlensL_depth": dict(hf_hub="TencentARC/ViT-Lens/vitlensL_depth.pt"),
    "vitlensL_tactile": dict(hf_hub="TencentARC/ViT-Lens/vitlensL_tactile.pt"),
    "vitlensL_eeg": dict(hf_hub="TencentARC/ViT-Lens/vitlensL_eeg.pt"),
    "vitlensB_pc": dict(hf_hub="TencentARC/ViT-Lens/vitlensB_pc.pt"),
    "vitlensB_pc_shapenet": dict(
        hf_hub="TencentARC/ViT-Lens/vitlensB_pc_shapenet.pt"),
    "vitlensB_depth": dict(hf_hub="TencentARC/ViT-Lens/vitlensB_depth.pt"),
    "vitlensB_tactile": dict(hf_hub="TencentARC/ViT-Lens/vitlensB_tactile.pt"),
    "vitlensB_eeg": dict(hf_hub="TencentARC/ViT-Lens/vitlensB_eeg.pt"),
    "vitlensG_pc": dict(hf_hub="TencentARC/ViT-Lens/vitlensG_pc.pt"),
    "vitlensG_pc_nolvis": dict(
        hf_hub="TencentARC/ViT-Lens/vitlensG_pc_nolvis.pt"),
}


def cache_dir() -> str:
    return os.environ.get(
        "VITLENS_CKPT_CACHE_DIR",
        os.path.expanduser("~/.cache/vitlens_tpu"))


def get_pretrained_cfg(model: str, tag: str) -> Optional[Dict[str, Any]]:
    return PRETRAINED_REGISTRY.get(f"{model}/{tag}") or PRETRAINED_REGISTRY.get(tag)


def cached_path(model: str, tag: str) -> str:
    """Where the cache keeps the file of ``model``/``tag``:
    ``<cache_dir>/<model>/<file name of the url or hub entry>``."""
    cfg = get_pretrained_cfg(model, tag)
    if cfg is None:
        raise KeyError(f"unknown pretrained tag {model}/{tag}")
    if "url" in cfg:
        fname = os.path.basename(cfg["url"].split("?")[0])
    else:
        hh = cfg.get("hf_hub", "")
        # "org/repo/" -> the default weights file; "org/repo/file.pt" -> file.pt
        fname = (hh.split("/", 2)[2].strip("/") if hh.count("/") >= 2 else ""
                 ) or "open_clip_pytorch_model.bin"
        fname = os.path.basename(fname)
    return os.path.join(cache_dir(), model.replace("/", "_"), fname)


def resolve_pretrained(model: str, tag: str) -> str:
    """Tag -> the local checkpoint path. A path that exists is returned as
    it is; a tag resolves to its file in the cache dir, and raises where the
    file is not there (the port does not download)."""
    if get_pretrained_cfg(model, tag) is None and os.path.exists(tag):
        return tag
    local = cached_path(model, tag)
    if os.path.exists(local):
        return local
    source = PRETRAINED_REGISTRY.get(f"{model}/{tag}") or PRETRAINED_REGISTRY[tag]
    where = source.get("url") or f"the HF hub repo {source.get('hf_hub')}"
    raise RuntimeError(
        f"checkpoint for {model}/{tag} not cached at {local} (offline "
        f"environment?): fetch it from {where} into that path")


def push_to_hf_hub(tower, config: Dict[str, Any], repo_id: str,
                   commit_message: str = "Add vitlens-tpu checkpoint",
                   private: bool = False, token: Optional[str] = None) -> str:
    """Publish a module's parameters (one npz, keyed by parameter name) and
    ``config`` (config.json) to the HF hub."""
    import tempfile

    import numpy as np

    try:
        from huggingface_hub import HfApi  # type: ignore
    except ImportError as e:
        raise ImportError("huggingface_hub required for push_to_hf_hub") from e

    with tempfile.TemporaryDirectory() as tmp:
        arrays = {n: p.detach().float().cpu().numpy()
                  for n, p in tower.named_parameters()}
        np.savez(os.path.join(tmp, "params.npz"), **arrays)
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(config, f, indent=2)
        api = HfApi(token=token)
        api.create_repo(repo_id, private=private, exist_ok=True)
        api.upload_folder(repo_id=repo_id, folder_path=tmp,
                          commit_message=commit_message)
    return f"https://huggingface.co/{repo_id}"
