"""Zero-shot prompt templates and label metadata (a copy of
vitlens_tpu/eval/metadata.py, which the port may not import).

Template sets mirror the reference's public prompt collections
(modal_audio/data/sound_cls_template.py, modal_depth/data/
scene_cls_template.py, training/zero_shot.py:836-840 tactile,
zero_shot.py EEG "an image of {}"). Large label/template tables (ModelNet40
labels, ESC50 folds, AudioSet classes, ImageNet classnames) are DATA and are
loaded from the metadata root ``$VITLENS_METADATA_DIR`` (the reference
repo's ``modal_*/data`` layout) and ``$VITLENS_IMAGENET_METADATA``.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional

SOUND_CLS_TEMPLATE = (
    lambda c: f"The sound of {c.lower()}.",
    lambda c: f"This is the sound of {c.lower()}.",
    lambda c: f"A sound of {c.lower()}.",
    lambda c: f"This is a sound of {c.lower()}.",
)

SOUND_AS_IMAGE_TEMPLATE = (
    lambda c: f"{c}.",
    lambda c: f"An image depicting {c}.",
    lambda c: f"{c}.",
    lambda c: f"An image showing {c}.",
    lambda c: f"{c}.",
    lambda c: f"This is {c}.",
    lambda c: f"A photograph shows {c}.",
    lambda c: f"An image of {c}.",
    lambda c: f"A good image of {c}.",
    lambda c: f"A photo of {c}.",
    lambda c: f"A picture of {c}.",
    lambda c: f"A bright image of {c}.",
)

SCENE_CLS_TEMPLATE = (
    lambda c: f"An image depicting a {c} environment.",
    lambda c: f"This location is best described as {c}.",
    lambda c: f"This location is {c}.",
    lambda c: f"A visual scene of {c} setting.",
    lambda c: f"This picture showcases a {c} environment.",
    lambda c: f"This place is {c}.",
    lambda c: f"An example of {c} scene category.",
    lambda c: f"An example of a {c} scene.",
    lambda c: f"This scene can be described as {c}.",
    lambda c: f"A visual scene of a {c} location.",
    lambda c: f"This photograph captures a {c} scene.",
    lambda c: f"This is a {c} setting.",
    lambda c: f"This image corresponds to a {c} scene.",
    lambda c: f"This photograph shows {c}.",
    lambda c: f"This is an image of {c}.",
    lambda c: f"A good image of {c}.",
    lambda c: f"A photo of the nice {c}.",
    lambda c: f"A picture of {c}.",
    lambda c: f"A bright image of {c}.",
)

TACTILE_MATERIAL_TEMPLATE = (
    lambda c: f"an image of {c}.",
    lambda c: f"a tactile image of {c}.",
)

TACTILE_PROPERTY_TEMPLATE = (
    lambda c: f"the meterial is {c}.",  # (sic — mirrors the reference prompt)
    lambda c: f"this type of material is {c}.",
)

EEG_TEMPLATE = (lambda c: f"an image of {c}.",)


def expand_templates(templates, classname: str) -> List[str]:
    """Apply a template set (callables or '{}' format strings)."""
    out = []
    for t in templates:
        out.append(t(classname) if callable(t) else t.format(classname))
    return out


# ---------------------------------------------------------------------------
# metadata roots
# ---------------------------------------------------------------------------


def metadata_dir(modality: str) -> str:
    env = os.environ.get("VITLENS_METADATA_DIR")
    sub = {
        "pc": "modal_3d/data", "audio": "modal_audio/data",
        "depth": "modal_depth/data", "tactile": "modal_tactile/data",
        "eeg": "modal_eeg/data",
    }[modality]
    if env and os.path.isdir(os.path.join(env, sub)):
        return os.path.join(env, sub)
    raise FileNotFoundError(
        f"no metadata dir for modality {modality!r}: set "
        f"VITLENS_METADATA_DIR to a directory containing {sub} (the "
        "reference repo's metadata layout)")


def load_pc_templates(prompt_set: str = "modelnet40_64") -> List[str]:
    d = metadata_dir("pc")
    with open(os.path.join(d, "templates.json")) as f:
        return json.load(f)[prompt_set]


def load_pc_labels(dataset: str = "modelnet40") -> List[str]:
    d = metadata_dir("pc")
    with open(os.path.join(d, "labels.json")) as f:
        return json.load(f)[dataset]


def load_esc50_labels() -> List[str]:
    d = metadata_dir("audio")
    with open(os.path.join(d, "esc50_label.json")) as f:
        labels = json.load(f)
    return labels


def load_audioset_classes() -> List[str]:
    """AudioSet 527 display names from class_labels_indices.csv."""
    d = metadata_dir("audio")
    out = []
    with open(os.path.join(d, "audioset_class_labels_indices.csv")) as f:
        for row in csv.DictReader(f):
            out.append(row["display_name"])
    return out


def load_vggsound_classes() -> List[str]:
    """VGGSound 309 class names from vggsound_stat.csv (header-less; column
    0 = name — reference VGGSoundCLSDataset.init_class_labels)."""
    d = metadata_dir("audio")
    out = []
    with open(os.path.join(d, "vggsound_stat.csv")) as f:
        for row in csv.reader(f):
            if row:
                out.append(row[0].strip())
    return out


def load_scene_names() -> List[str]:
    """Shared depth scene-name list: the reference ships ONE file
    (nyu-depth-v2_scene_name.json) used by both NYU and SUN-RGBD evals."""
    d = metadata_dir("depth")
    with open(os.path.join(d, "nyu-depth-v2_scene_name.json")) as f:
        return json.load(f)


def load_imagenet_cls_mapping() -> Dict:
    d = metadata_dir("eeg")
    with open(os.path.join(d, "imagenet_cls_mapping.json")) as f:
        return json.load(f)


def load_openai_imagenet_metadata():
    """The 80 OpenAI ImageNet prompt templates + 1000 classnames
    (reference zero_shot_metadata.py, 266 LoC of public CLIP data). Loaded
    from $VITLENS_IMAGENET_METADATA (a python file or json with
    OPENAI_IMAGENET_TEMPLATES / IMAGENET_CLASSNAMES)."""
    env = os.environ.get("VITLENS_IMAGENET_METADATA")
    if env and env.endswith(".json"):
        with open(env) as f:
            d = json.load(f)
        return d["templates"], d["classnames"]
    if env and os.path.exists(env):
        import importlib.util

        spec = importlib.util.spec_from_file_location("_zs_metadata", env)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        templates = getattr(mod, "OPENAI_IMAGENET_TEMPLATES", None) or \
            getattr(mod, "openai_imagenet_template", None)
        classnames = getattr(mod, "IMAGENET_CLASSNAMES", None) or \
            getattr(mod, "imagenet_classnames", None)
        if templates is not None and classnames is not None:
            return list(templates), list(classnames)
    raise FileNotFoundError(
        "ImageNet zero-shot metadata not found; set VITLENS_IMAGENET_METADATA"
    )
