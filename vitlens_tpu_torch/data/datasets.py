"""Modality datasets (port of vitlens_tpu/data/datasets.py, over the port's
processors and augmentations: the same items for the same seed and index).

Re-implements the reference dataset classes against the same metadata
formats (annotation JSON/TSV layouts listed per class below). Raw-data
roots come from env vars VITLENS_{PC,AUDIO,DEPTH,TACTILE,EEG}_DATA_DIR;
annotation/metadata files resolve via vitlens_tpu_torch.eval.metadata.metadata_dir
(reference constants.py:19-46 *_DATA_DIR / *_META_DATA_DIR).

Every dataset exposes:
  .eval_metric in {"acc", "map", "recall"}   (dispatch key, as in the
                                              reference modal_audio datasets)
  .classnames / .templates                    (zero-shot classifier inputs)
  __getitem__ -> dict of numpy arrays
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, List, Optional

import numpy as np

from vitlens_tpu_torch.data.rng import ThreadLocalRNG

from vitlens_tpu_torch.data import augment as A
from vitlens_tpu_torch.data import processors as P
from vitlens_tpu_torch.eval import metadata as MD


def _env_root(name: str, default: Optional[str] = None) -> str:
    v = os.environ.get(f"VITLENS_{name}_DATA_DIR", default)
    if not v:
        raise FileNotFoundError(
            f"set VITLENS_{name}_DATA_DIR to the {name.lower()} data root"
        )
    return v


# ---------------------------------------------------------------------------
# Audio
# ---------------------------------------------------------------------------


class ESC50Dataset:
    """ESC-50 5-fold environmental sound classification (reference
    modal_audio/datasets.py:561-643). Annotations: esc50_fold-{k}.json with
    {audio_path, text, class_label}; labels: esc50_label.json {id: [name]}."""

    eval_metric = "acc"

    def __init__(self, fold: str = "1", data_root: Optional[str] = None,
                 n_clip: int = 3, train: bool = False,
                 anno_path: Optional[str] = None,
                 label_path: Optional[str] = None,
                 proc_kwargs: Optional[dict] = None):
        meta = MD.metadata_dir("audio")
        with open(anno_path or os.path.join(meta, f"esc50_fold-{fold}.json")) as f:
            self.annotation = json.load(f)
        with open(label_path or os.path.join(meta, "esc50_label.json")) as f:
            labels = json.load(f)
        self.classnames = [labels[str(i)][0] for i in range(len(labels))]
        self.templates = MD.SOUND_AS_IMAGE_TEMPLATE
        self.data_root = data_root or _env_root("AUDIO")
        self.proc = P.AudioProcessor(n_clip=n_clip, **(proc_kwargs or {}))
        self.train = train

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, idx):
        ann = self.annotation[idx]
        x = self.proc([os.path.join(self.data_root, ann["audio_path"])])[0]
        return {
            "id": idx,
            "audio": x,  # [n_clip, T, F]
            "label": int(ann["class_label"]),
            "caption_str": ann.get("text", ""),
        }


class AudioClsDataset:
    """Multi-label audio classification (AudioSet-style; reference
    modal_audio/datasets.py:271-404). Annotation: list of {audio_path /
    wav, labels: [class ids] or label_indices}, class list from
    audioset_class_labels_indices.csv. Train mode: waveform mixup
    Beta(10,10) + SpecAug; captions from SOUND_AS_IMAGE_TEMPLATE."""

    eval_metric = "map"

    def __init__(self, anno_path: str, data_root: Optional[str] = None,
                 classnames: Optional[List[str]] = None, train: bool = False,
                 n_clip: int = 3, mixup_prob: float = 0.5, seed: int = 0,
                 proc_kwargs: Optional[dict] = None,
                 freq_mask: int = 48, time_mask: int = 192,
                 noise_aug: bool = True):
        # aug knobs match the reference flags --audio_freqm/--audio_timem/
        # --audio_noise_aug/--audio_mix_up (params.py:884-937); mix_up off =
        # mixup_prob 0
        with open(anno_path) as f:
            self.annotation = json.load(f)
        self.classnames = classnames or MD.load_audioset_classes()
        self.templates = MD.SOUND_AS_IMAGE_TEMPLATE
        self.data_root = data_root or _env_root("AUDIO")
        self.train = train
        self.mixup_prob = mixup_prob
        self.n_clip = 1 if train else n_clip
        self.proc = P.AudioProcessor(n_clip=self.n_clip, **(proc_kwargs or {}))
        self.freq_mask, self.time_mask = freq_mask, time_mask
        self.noise_aug = noise_aug
        self.rng = ThreadLocalRNG(seed)  # loader threads share this dataset

    def __len__(self):
        return len(self.annotation)

    def _labels_multihot(self, ann) -> np.ndarray:
        mh = np.zeros(len(self.classnames), np.float32)
        raw = ann.get("labels", ann.get("label_indices",
                                        ann.get("class_labels", [])))
        if isinstance(raw, (int, np.integer)):
            raw = [raw]
        for li in raw:
            mh[int(li)] = 1.0
        return mh

    def _load_wf(self, ann):
        from vitlens_tpu_torch.data.audio_decode import load_audio_file, resample

        wf, sr = load_audio_file(
            os.path.join(self.data_root, ann["audio_path"]))
        if sr != self.proc.sr:
            wf = resample(wf, sr, self.proc.sr)
        return wf

    def __getitem__(self, idx):
        ann = self.annotation[idx]
        targets = self._labels_multihot(ann)
        if self.train:
            wf = self._load_wf(ann)
            if self.rng.random_sample() < self.mixup_prob:
                j = int(self.rng.randint(0, len(self.annotation)))
                wf2 = self._load_wf(self.annotation[j])
                wf, lam = A.waveform_mixup(wf, wf2, self.rng)
                # reference target is the binary UNION of both clips'
                # labels (all ones — datasets.py:387-392), NOT lam-weighted
                # soft targets; lam only mixes the waveforms
                targets = np.maximum(
                    targets, self._labels_multihot(self.annotation[j]))
            fb = self.proc.process_waveform(wf, self.proc.sr, rng=self.rng,
                                            random_clip=True)[0]
            fb = A.spec_augment(fb, self.rng, freq_mask=self.freq_mask,
                                time_mask=self.time_mask,
                                noise=self.noise_aug,
                                mask_value=-self.proc.mean / self.proc.std)
            label_ids = np.where(targets > 0.5)[0]
            name = self.classnames[int(label_ids[0])] if len(label_ids) else ""
            t_idx = self.rng.randint(0, len(self.templates))
            caption = self.templates[t_idx](name)
            return {"id": idx, "audio": fb, "targets": targets,
                    "caption_str": caption}
        x = self.proc([os.path.join(self.data_root, ann["audio_path"])])[0]
        return {"id": idx, "audio": x, "targets": targets,
                "label": int(np.argmax(targets))}


class AudioRetrievalDataset:
    """AudioCaps/Clotho retrieval (reference modal_audio/datasets.py:405-560).
    TSV rows: uniq_id \t audio_path \t text \t duration; texts json:
    {str(audio_id): [captions]} or list aligned with rows.

    train=True switches to the reference's retrieval TRAIN recipe: one
    random clip (RandomClipSampler, at_processor.py:329-333) + optional
    SpecAug, and items carry the row's caption so the dual/tri contrastive
    step can tokenize it (reference __getitem__ returns
    {audio, caption, uniq_id}, datasets.py:466-481)."""

    eval_metric = "recall"

    def __init__(self, tsv_path: str, texts_path: str,
                 data_root: Optional[str] = None, n_clip: int = 3,
                 proc_kwargs: Optional[dict] = None, train: bool = False,
                 seed: int = 0, freq_mask: int = 48, time_mask: int = 192,
                 noise_aug: bool = True, **_ignored_aug):
        self.rows = []
        with open(tsv_path) as f:
            for line in csv.reader(f, delimiter="\t"):
                if not line:
                    continue
                if not line[0].strip().isdigit():  # header row
                    continue
                self.rows.append(line)
        if os.path.exists(texts_path):
            with open(texts_path) as f:
                texts = json.load(f)
        elif train:
            # train splits ship no retrieval-corpus json; the per-row tsv
            # captions are the text side (used for in-training recall eval)
            texts = {r[0]: [r[2]] for r in self.rows if len(r) > 2}
        else:
            raise FileNotFoundError(texts_path)
        self.train = train
        if train:
            n_clip = 1
        self.rng = ThreadLocalRNG(seed)  # loader threads share this dataset
        self.freq_mask, self.time_mask = freq_mask, time_mask
        self.noise_aug = noise_aug
        # texts: mapping id -> list[str] or flat list of [id, caption]
        self.texts: List[str] = []
        self.text_ids: List[int] = []
        if isinstance(texts, dict):
            for k, caps in texts.items():
                for c in (caps if isinstance(caps, list) else [caps]):
                    self.texts.append(c)
                    self.text_ids.append(int(k))
        else:
            # list form is "aligned with rows": text i belongs to row i,
            # whose retrieval id is the TSV uniq_id — NOT the enumeration
            # index (audio items carry uniq_id, and Recall matches on it)
            for i, caps in enumerate(texts):
                tid = int(self.rows[i][0]) if i < len(self.rows) else i
                for c in (caps if isinstance(caps, list) else [caps]):
                    self.texts.append(c)
                    self.text_ids.append(tid)
        self.data_root = data_root or _env_root("AUDIO")
        self.proc = P.AudioProcessor(n_clip=n_clip, **(proc_kwargs or {}))

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        row = self.rows[idx]
        uniq_id, audio_path = int(row[0]), row[1]
        path = os.path.join(self.data_root, audio_path)
        if self.train:
            from vitlens_tpu_torch.data.audio_decode import load_audio_file, resample

            wf, sr = load_audio_file(path)
            if sr != self.proc.sr:
                wf = resample(wf, sr, self.proc.sr)
            fb = self.proc.process_waveform(wf, self.proc.sr, rng=self.rng,
                                            random_clip=True)[0]
            fb = A.spec_augment(fb, self.rng, freq_mask=self.freq_mask,
                                time_mask=self.time_mask,
                                noise=self.noise_aug,
                                mask_value=-self.proc.mean / self.proc.std)
            caption = row[2] if len(row) > 2 else ""
            return {"id": uniq_id, "audio": fb, "caption_str": caption}
        x = self.proc([path])[0]
        return {"id": uniq_id, "audio": x}


# ---------------------------------------------------------------------------
# Depth (SUN-RGBD / NYUv2 — reference modal_depth/datasets.py:116-262)
# ---------------------------------------------------------------------------


class RGBDDataset:
    """Annotations: SUN-RGBD_{split}.json / NYU-Depth-v2_{split}.json with
    {image_path, disparity_path, label, cleaned_label}. Train split repeats
    x50 (datasets.py:176-177). Items: image, depth, caption from
    SCENE_CLS_TEMPLATE, label."""

    eval_metric = "acc"

    def __init__(self, name: str = "sun-rgbd", split: str = "val",
                 data_root: Optional[str] = None, train_repeat: int = 50,
                 seed: int = 0, anno_path: Optional[str] = None,
                 image_size: int = 224):
        if anno_path is None:
            meta = MD.metadata_dir("depth")
            fname = {"sun-rgbd": f"SUN-RGBD_{split}.json",
                     "nyu-depth-v2": f"NYU-Depth-v2_{split}.json"}[name]
            anno_path = os.path.join(meta, fname)
        with open(anno_path) as f:
            self.annotation = json.load(f)
        self.train = split == "train"
        if self.train and train_repeat > 1:
            self.annotation = self.annotation * train_repeat
        self.classnames = sorted({a["cleaned_label"] for a in self.annotation})
        self.label2idx = {c: i for i, c in enumerate(self.classnames)}
        self.templates = MD.SCENE_CLS_TEMPLATE
        self.data_root = data_root or _env_root("DEPTH")
        self.depth_proc = P.DepthProcessor(image_size=image_size)
        self.image_proc = P.ImageProcessor(image_size=image_size)
        self.rng = ThreadLocalRNG(seed)  # loader threads share this dataset

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, idx):
        ann = self.annotation[idx]
        depth = self.depth_proc([os.path.join(self.data_root,
                                              ann["disparity_path"])])[0]
        out = {
            "id": idx,
            "depth": depth,
            "label": self.label2idx[ann["cleaned_label"]],
        }
        img_path = os.path.join(self.data_root, ann["image_path"])
        if os.path.exists(img_path):
            out["image"] = self.image_proc([img_path])[0]
        if self.train:
            t = self.templates[self.rng.randint(0, len(self.templates))]
            out["caption_str"] = t(ann["cleaned_label"])
        return out


# ---------------------------------------------------------------------------
# Tactile (Touch-and-Go — reference modal_tactile/datasets.py:105-255)
# ---------------------------------------------------------------------------

TAG_MATERIALS = [
    "concrete", "plastic", "glass", "wood", "metal", "brick", "tile",
    "leather", "fabric", "paper", "grass", "tree", "soil", "gravel",
    "rock", "sand", "plants", "rubber", "synthetic fabric", "others",
]
TAG_HARD = ["soft", "hard"]
TAG_ROUGH = ["smooth", "rough"]


class TAGDataset:
    """Touch-and-Go GelSight frames. Annotations: {split}.json /
    {split}_rough.json with {gel_path, image_path, material_label/
    sr_label/hs_label}. Label set keyed by task (material/hard/rough);
    pretrain split repeats x40."""

    eval_metric = "acc"

    def __init__(self, split: str = "test_material",
                 data_root: Optional[str] = None, n_repeat_train: int = 40,
                 seed: int = 0, anno_path: Optional[str] = None,
                 image_size: int = 224):
        if anno_path is None:
            meta = MD.metadata_dir("tactile")
            fname = {"pretrain": "pretrain.json",
                     "train_material": "train.json", "test_material": "test.json",
                     "train_hard": "train.json", "test_hard": "test.json",
                     "train_rough": "train_rough.json",
                     "test_rough": "test_rough.json"}[split]
            anno_path = os.path.join(meta, fname)
        with open(anno_path) as f:
            self.annotation = json.load(f)
        if split == "pretrain" and n_repeat_train > 1:
            self.annotation = self.annotation * n_repeat_train
        self.split = split
        if "material" in split or split == "pretrain":
            self.classnames = TAG_MATERIALS
            self.templates = MD.TACTILE_MATERIAL_TEMPLATE
            self.label_key = "material_label"
        elif "hard" in split:
            self.classnames = TAG_HARD
            self.templates = MD.TACTILE_PROPERTY_TEMPLATE
            self.label_key = "hs_label"
        else:
            self.classnames = TAG_ROUGH
            self.templates = MD.TACTILE_PROPERTY_TEMPLATE
            self.label_key = "sr_label"
        self.data_root = data_root or _env_root("TACTILE")
        self.proc = P.TactileProcessor(image_size=image_size)
        self.image_proc = P.ImageProcessor(image_size=image_size)
        self.rng = ThreadLocalRNG(seed)  # loader threads share this dataset

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, idx):
        ann = self.annotation[idx]
        tact = self.proc([os.path.join(self.data_root, ann["gel_path"])])[0]
        out = {"id": idx, "tactile": tact,
               "label": int(ann[self.label_key] or 0)}
        if ann.get("image_path"):
            img_path = os.path.join(self.data_root, ann["image_path"])
            if os.path.exists(img_path):
                out["image"] = self.image_proc([img_path])[0]
        if "train" in self.split or self.split == "pretrain":
            name = self.classnames[out["label"]]
            t = self.templates[self.rng.randint(0, len(self.templates))]
            out["caption_str"] = t(name)
        return out


# ---------------------------------------------------------------------------
# EEG (ImageNet-EEG — reference modal_eeg/datasets.py:64-157)
# ---------------------------------------------------------------------------


class EEGDataset:
    """eeg_5_95_std.pth blob: {dataset: [{eeg [C,T] tensor, label, image}],
    labels: [synsets], images: [names]}; block_splits file picks indices.
    Filters 450 <= T <= 600; train repeats x50; caption 'an image of {cls}'."""

    eval_metric = "acc"

    def __init__(self, split: str = "val", data_root: Optional[str] = None,
                 split_num: int = 0, n_repeat_train: int = 50,
                 image_root: Optional[str] = None, image_size: int = 224):
        import torch

        root = data_root or _env_root("EEG")
        blob = torch.load(os.path.join(root, "eeg_5_95_std.pth"),
                          map_location="cpu", weights_only=False)
        self.dataset = blob["dataset"]
        self.synset_labels = blob["labels"]
        self.image_list = blob["images"]
        splits = torch.load(os.path.join(root, "block_splits_by_image_all.pth"),
                            map_location="cpu", weights_only=False)
        idxs = splits["splits"][split_num][split]
        self.indices = [i for i in idxs
                        if 450 <= self.dataset[i]["eeg"].shape[1] <= 600]
        self.train = split in ("train", "pretrain")
        if self.train and n_repeat_train > 1:
            self.indices = self.indices * n_repeat_train
        mapping = MD.load_imagenet_cls_mapping()
        self.classnames = [mapping[s][0] for s in self.synset_labels]
        self.templates = MD.EEG_TEMPLATE
        self.image_root = image_root or os.path.join(root, "imageNet_images")
        self.proc = P.EEGProcessor()
        self.image_proc = P.ImageProcessor(image_size=image_size)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        item = self.dataset[self.indices[idx]]
        eeg = self.proc.process_array(np.asarray(item["eeg"], np.float32))
        label = int(item["label"])
        out = {"id": idx, "eeg": eeg, "label": label}
        img_name = self.image_list[item["image"]]
        synset = img_name.split("_")[0]
        img_path = os.path.join(self.image_root, synset, img_name + ".JPEG")
        if os.path.exists(img_path):
            out["image"] = self.image_proc([img_path])[0]
        if self.train:
            out["caption_str"] = f"an image of {self.classnames[label]}."
        return out


# ---------------------------------------------------------------------------
# Video (closes the reference's unfinished video path: modal_video ships
# processors only; frame-loading semantics follow at_processor.py:113-160
# read_pil_frames_from_decord, with decoding pluggable: frame directories by
# default, any decode_fn for other sources)
# ---------------------------------------------------------------------------


class VideoDataset:
    """Real-data video training/eval.

    Annotation json: [{video_path, text|caption, label?}] where video_path
    is a pre-extracted frame directory (ordered jpg/png), or any source a
    user-supplied decode_fn(path) -> [T,H,W,3] uint8 can read. Train mode
    samples jittered frame indices + RandomResizedCrop; eval takes segment
    centers + center crop (optionally 3-crop aggregation,
    zero_shot.py:460-569)."""

    eval_metric = "recall"

    def __init__(self, anno_path: str, data_root: Optional[str] = None,
                 n_frames: int = 8, image_size: int = 224,
                 train: bool = False, seed: int = 0,
                 decode_fn: Optional[Any] = None, three_crop: bool = False,
                 rand_aug: bool = True, rand_aug_n: int = 2,
                 rand_aug_m: float = 5.0):
        from vitlens_tpu_torch.data import video_processors as VP

        with open(anno_path) as f:
            self.annotation = json.load(f)
        self.data_root = data_root or _env_root("VIDEO")
        self.train = train
        self.proc = VP.VideoProcessor(
            n_frames=n_frames, size=image_size, train=train, seed=seed,
            decode_fn=decode_fn, three_crop=three_crop and not train,
            rand_aug=rand_aug, rand_aug_n=rand_aug_n, rand_aug_m=rand_aug_m)
        labels = sorted({a["label"] for a in self.annotation
                         if a.get("label") is not None})
        if labels and all(isinstance(l, str) for l in labels):
            self.classnames = labels
            self._label_idx = {l: i for i, l in enumerate(labels)}
        else:
            self.classnames = None
            self._label_idx = None
        self.templates = ["a video of {}."]
        # retrieval corpus: per-item captions (reference test_vidret,
        # zero_shot.py:460-569); labeled sets dispatch to classification
        self.texts: List[str] = []
        self.text_ids: List[int] = []
        for i, a in enumerate(self.annotation):
            cap = a.get("text") or a.get("caption")
            if cap:
                self.texts.append(cap)
                self.text_ids.append(i)
        if not self.texts and labels:
            self.eval_metric = "acc"

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, idx):
        ann = self.annotation[idx]
        src = os.path.join(self.data_root, ann["video_path"])
        x = self.proc.process_one(src).astype(np.float32)
        out = {"id": idx, "video": x}
        caption = ann.get("text") or ann.get("caption") or ""
        if caption:
            out["caption_str"] = caption
        label = ann.get("label")
        if label is not None:
            if self._label_idx is not None and isinstance(label, str):
                label = self._label_idx[label]
            out["label"] = int(label)
            if not caption:
                name = (self.classnames[out["label"]]
                        if self.classnames else str(label))
                out["caption_str"] = self.templates[0].format(name)
        return out


# ---------------------------------------------------------------------------
# 3D point cloud (reference modal_3d/datasets.py:214-883)
# ---------------------------------------------------------------------------


class ModelNetDataset:
    """ModelNet40 zero-shot test set. Supports the preprocessed
    modelnet40_test_8192pts_fps.dat pickle (list_of_points/list_of_labels)
    or raw txt files per shape."""

    eval_metric = "acc"

    def __init__(self, data_root: Optional[str] = None, split: str = "test",
                 npoints: int = 8192, num_category: int = 40):
        self.root = data_root or _env_root("PC")
        self.npoints = npoints
        catfile = os.path.join(self.root, f"modelnet{num_category}_shape_names.txt")
        self.classnames = [l.rstrip() for l in open(catfile)]
        self.templates = MD.load_pc_templates("modelnet40_64")
        dat = os.path.join(
            self.root, f"modelnet{num_category}_{split}_{npoints}pts_fps.dat")
        if os.path.exists(dat):
            import pickle

            with open(dat, "rb") as f:
                self.points, self.labels = pickle.load(f)
        else:
            ids = [l.rstrip() for l in
                   open(os.path.join(self.root, f"modelnet{num_category}_{split}.txt"))]
            names = ["_".join(x.split("_")[:-1]) for x in ids]
            cls = {c: i for i, c in enumerate(self.classnames)}
            self.files = [(cls[n], os.path.join(self.root, n, f"{i}.txt"))
                          for n, i in zip(names, ids)]
            self.points = None

    def __len__(self):
        return len(self.labels) if self.points is not None else len(self.files)

    def __getitem__(self, idx):
        if self.points is not None:
            pts = np.asarray(self.points[idx][:, :3], np.float32)
            label = int(np.asarray(self.labels[idx]).reshape(-1)[0])
        else:
            label, path = self.files[idx]
            pts = np.loadtxt(path, delimiter=",").astype(np.float32)[:, :3]
        if pts.shape[0] > self.npoints:
            pts = pts[: self.npoints]
        pts = P.pc_normalize(pts)
        return {"id": idx, "pc": pts.astype(np.float32), "label": label}


class ScanObjectNNDataset:
    """ScanObjectNN h5 test set (reference modal_3d/datasets.py:496-570)."""

    eval_metric = "acc"
    CLASSNAMES = ["bag", "bin", "box", "cabinet", "chair", "desk", "display",
                  "door", "shelf", "table", "bed", "pillow", "sink", "sofa",
                  "toilet"]

    def __init__(self, h5_path: Optional[str] = None, npoints: int = 8192):
        import h5py

        path = h5_path or os.path.join(
            _env_root("PC"), "scanobjectnn", "test_objectdataset.h5")
        with h5py.File(path, "r") as f:
            self.points = np.asarray(f["data"], np.float32)
            self.labels = np.asarray(f["label"], np.int64)
        self.npoints = npoints
        self.classnames = self.CLASSNAMES
        self.templates = MD.load_pc_templates("modelnet40_64")

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        pts = self.points[idx]
        if pts.shape[0] < self.npoints:  # upsample by repetition
            reps = -(-self.npoints // pts.shape[0])
            pts = np.tile(pts, (reps, 1))[: self.npoints]
        else:
            pts = pts[: self.npoints]
        pts = P.pc_normalize(pts)
        return {"id": idx, "pc": pts.astype(np.float32),
                "label": int(self.labels[idx])}


class ObjaverseDataset:
    """ULIP2-Objaverse triplet buckets (reference Objverse,
    modal_3d/datasets.py:395-494): a directory of LMDB buckets named
    `*_<i>`, each entry = pickle of (pc [N,3], [jpeg bytes, ...],
    [[captions...], ...]); a random rendered view + caption is drawn per
    sample and the reference augmentation chain applied
    (dropout -> scale -> shift -> small-rotation -> y-rotation).

    Without the lmdb package the pure-Python reader (``lmdb_reader``) opens
    the buckets; buckets may also be directories of `<idx>.pkl` files with
    the same tuples (the loader dispatches on what it finds)."""

    eval_metric = "acc"

    def __init__(self, root: Optional[str] = None, augment: bool = True,
                 seed: int = 0, image_size: int = 224):
        import pickle

        self.root = root or os.path.join(_env_root("PC"), "ulip_batches")
        self.pickle = pickle
        buckets = sorted(
            os.listdir(self.root),
            key=lambda x: int(x.split(".")[0].split("_")[-1]))
        self.buckets = [os.path.join(self.root, b) for b in buckets]
        try:
            import lmdb  # type: ignore

            self._lmdb = lmdb
        except ImportError:
            # pure-Python read-only LMDB implementation (same API subset)
            from vitlens_tpu_torch.data import lmdb_reader

            self._lmdb = lmdb_reader
        self._envs = [None] * len(self.buckets)
        self.counts = [self._bucket_len(i) for i in range(len(self.buckets))]
        self.cumulative = np.cumsum(self.counts)
        self.augment = augment
        self.rng = ThreadLocalRNG(seed)  # loader threads share this dataset
        self.image_size = image_size

    def _bucket_len(self, i: int) -> int:
        path = self.buckets[i]
        if os.path.isdir(path):  # pickle-per-entry fixture layout
            return len([f for f in os.listdir(path) if f.endswith(".pkl")])
        # LMDB file: self._lmdb is always importable (the pure-Python
        # reader backs the ImportError branch) and open() raises its own
        # clear error for a path that is not an LMDB database
        env = self._lmdb.open(path, readonly=True, lock=False)
        with env.begin() as txn:
            n = txn.stat()["entries"]
        self._envs[i] = env
        return n

    def __len__(self):
        return int(self.cumulative[-1]) if len(self.cumulative) else 0

    def _load_entry(self, idx: int):
        b = int(np.searchsorted(self.cumulative, idx, side="right"))
        local = idx - (0 if b == 0 else int(self.cumulative[b - 1]))
        path = self.buckets[b]
        if self._envs[b] is not None:
            with self._envs[b].begin() as txn:
                return self.pickle.loads(txn.get(str(local).encode("ascii")))
        with open(os.path.join(path, f"{local}.pkl"), "rb") as f:
            return self.pickle.load(f)

    def __getitem__(self, idx):
        import io

        from PIL import Image

        pc, imgs, texts = self._load_entry(idx)
        pc = P.pc_normalize(np.asarray(pc, np.float32))
        if self.augment:
            pc = A.random_point_dropout(pc, self.rng)
            pc = A.random_scale(pc, self.rng)
            pc = A.random_shift(pc, self.rng)
            pc = A.rotate_perturbation(pc, self.rng)
            pc = A.rotate_point_cloud_y(pc, self.rng)
        img_idx = int(self.rng.randint(0, len(imgs)))
        img = Image.open(io.BytesIO(imgs[img_idx]))
        image = A.train_image_transform(img, self.rng, self.image_size)
        textlist = texts[img_idx]
        caption = textlist[int(self.rng.randint(0, len(textlist)))]
        return {"id": idx, "pc": pc.astype(np.float32), "image": image,
                "caption_str": caption}


class PCTripletDataset:
    """ULIP-style (pc, rendered image, caption) triplets for training
    (reference ShapeNet/Objverse, modal_3d/datasets.py:395-494, :572-771).
    Annotation: json list of {pc_path(.npy), image_path, caption or
    taxonomy name}; augmentation chain per reference."""

    eval_metric = "acc"

    def __init__(self, anno_path: str, data_root: Optional[str] = None,
                 npoints: int = 8192, augment: bool = True,
                 prompt_set: str = "shapenet_64", seed: int = 0,
                 image_size: int = 224):
        with open(anno_path) as f:
            self.annotation = json.load(f)
        self.data_root = data_root or _env_root("PC")
        self.npoints = npoints
        self.augment = augment
        self.templates = MD.load_pc_templates(prompt_set)
        self.rng = ThreadLocalRNG(seed)  # loader threads share this dataset
        self.image_proc = P.ImageProcessor(image_size=image_size)

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, idx):
        ann = self.annotation[idx]
        pts = np.load(os.path.join(self.data_root, ann["pc_path"])).astype(
            np.float32)[:, :3]
        if pts.shape[0] >= self.npoints:
            sel = self.rng.permutation(pts.shape[0])[: self.npoints]
            pts = pts[sel]
        else:
            reps = -(-self.npoints // pts.shape[0])
            pts = np.tile(pts, (reps, 1))[: self.npoints]
        pts = P.pc_normalize(pts)
        if self.augment:
            pts = A.train_point_transform(pts, self.rng)
        name = ann.get("caption") or ann.get("name", "")
        t = self.templates[self.rng.randint(0, len(self.templates))]
        caption = t.format(name) if "{}" in t else t
        out = {"id": idx, "pc": pts.astype(np.float32), "caption_str": caption}
        img = ann.get("image_path")
        if img:
            p = os.path.join(self.data_root, img)
            if os.path.exists(p):
                out["image"] = self.image_proc([p])[0]
        return out


# ---------------------------------------------------------------------------
# facades ("name@split::name@split" parsing — reference
# modal_audio/datasets.py create_audio_datasets :765+, depth :264+)
# ---------------------------------------------------------------------------


def create_audio_datasets(spec: str, train: bool = False,
                          proc_kwargs: Optional[dict] = None,
                          aug_kwargs: Optional[dict] = None) -> List[Any]:
    """e.g. 'esc50@fold-1::audiocaps@test'. proc_kwargs forwards fbank
    geometry (sampling_rate/clip_duration/target_length/mel_bins) to the
    AudioProcessor so the data pipeline follows the model config (e.g. the
    2-sec variant); aug_kwargs forwards train-time aug knobs
    (freq_mask/time_mask/noise_aug/mixup_prob) to classification datasets."""
    out = []
    for part in spec.split("::"):
        name, _, split = part.partition("@")
        meta = MD.metadata_dir("audio")
        if name == "esc50":
            fold = split.replace("fold-", "") or "1"
            out.append(ESC50Dataset(fold=fold, train=train,
                                    proc_kwargs=proc_kwargs))
        elif name in ("audiocaps", "clotho"):
            # clotho ships split files named validation/evaluation
            # (reference datasets.py:489-497 anno_path)
            fsplit = split
            if name == "clotho":
                fsplit = {"val": "validation", "test": "evaluation"}.get(
                    split, split)
            tsv = os.path.join(meta, f"{name}_{fsplit}_new.tsv")
            txt = os.path.join(meta, f"{name}_{fsplit}_texts.json")
            out.append(AudioRetrievalDataset(tsv, txt, train=train,
                                             proc_kwargs=proc_kwargs,
                                             **(aug_kwargs or {})))
        elif name == "vggsound":
            fname = f"vggsound_audio-only_{split or 'val'}.json"
            ds = AudioClsDataset(os.path.join(meta, fname), train=train,
                                 classnames=MD.load_vggsound_classes(),
                                 proc_kwargs=proc_kwargs,
                                 **(aug_kwargs or {}))
            ds.eval_metric = "acc"  # single-label top-1 (reference :675)
            out.append(ds)
        elif name == "audioset":
            anno = os.path.join(meta, f"{name}_{split}.json")
            out.append(AudioClsDataset(anno, train=train,
                                       proc_kwargs=proc_kwargs,
                                       **(aug_kwargs or {})))
        else:
            raise ValueError(f"unknown audio dataset {name!r}")
    return out


def create_rgbd_datasets(spec: str, image_size: int = 224) -> List[RGBDDataset]:
    """e.g. 'sun-rgbd@val::nyu-depth-v2@val'."""
    out = []
    for part in spec.split("::"):
        name, _, split = part.partition("@")
        out.append(RGBDDataset(name=name, split=split or "val",
                               image_size=image_size))
    return out
