"""Every dataset class of the port (vitlens_tpu_torch/data/datasets.py) on a
fixture written here, against the JAX package's datasets.py: the same items
(arrays exact; labels, ids and captions equal) for the same seed and index,
drawn in the same order in this thread, and the same classnames, templates
and retrieval corpora. The audio fixtures mix WAV and FLAC files.

The host fbank of both sides is a deterministic stand-in here (the first
samples of each clip, reshaped): the two fbanks agree to 2e-4 on the
normalised output, which tests/test_torch_fbank.py holds, and the port's
host fbank is not bitwise repeatable (two calls on the same clips have
differed by up to 9e-6). What this file holds is everything around it
(decode, resample, clip windows, mixup, SpecAugment, labels, captions)."""

import io
import json
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from tools.reference_layout import pcm_from_float, write_flac, write_wav
from vitlens_tpu.data import datasets as JD
from vitlens_tpu.data import lmdb_reader as JL
from vitlens_tpu_torch.data import datasets as PD
from tests.test_torch_threads import share_cores

share_cores()

SR = 16000


def _frames(batch, target_length, num_mel_bins, **_):
    """A deterministic stand-in for the fbank: the first target_length x
    num_mel_bins samples of each clip, in fp32."""
    x = np.asarray(batch, np.float64)[:, :target_length * num_mel_bins]
    return x.reshape(len(x), target_length, num_mel_bins).astype(np.float32)


@pytest.fixture(autouse=True)
def _shared_fbank(monkeypatch):
    import vitlens_tpu.ops.fbank as JF
    import vitlens_tpu_torch.ops.fbank as PF

    monkeypatch.setattr(JF, "fbank_fixed_length", _frames)
    monkeypatch.setattr(PF, "fbank_fixed_length",
                        lambda x, **kw: torch.from_numpy(_frames(x.numpy(), **kw)))


def _same(a, b, key=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (key, a.keys(), b.keys())
        for k in a:
            _same(a[k], b[k], k)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, key
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=key)
    else:
        assert a == b, (key, a, b)


def _items(pds, jds, idxs=None):
    assert len(pds) == len(jds)
    for i in (idxs if idxs is not None else range(len(pds))):
        _same(pds[i], jds[i])


def _tone(seconds, f, seed, rate=SR):
    rng = np.random.RandomState(seed)
    t = np.arange(int(rate * seconds)) / rate
    return 0.3 * np.sin(2 * np.pi * f * t) + 0.02 * rng.randn(t.size)


def _audio_fixture(root, n=6):
    """n clips of 3-8 s under root/audio (every third FLAC, one at 22.05
    kHz), an AudioSet-style annotation, its class CSV, ESC50 fold and label
    files, AudioCaps tsv and texts and a VGGSound split."""
    (root / "audio").mkdir(parents=True)
    meta = root / "meta" / "modal_audio" / "data"
    meta.mkdir(parents=True)
    paths = []
    for i in range(n):
        rate = 22050 if i == 4 else SR
        pcm = pcm_from_float(_tone(3 + i, 200 + 90 * i, i, rate), 16)
        if i % 3 == 2:
            name = f"audio/c{i}.flac"
            write_flac(str(root / name), pcm, rate)
        else:
            name = f"audio/c{i}.wav"
            write_wav(str(root / name), pcm[None], rate)
        paths.append(name)
    (meta / "audioset_train.json").write_text(json.dumps(
        [{"uniq_id": i, "audio_path": p, "labels": [i % 4, (i + 1) % 4]}
         for i, p in enumerate(paths)]))
    (meta / "audioset_class_labels_indices.csv").write_text(
        "index,mid,display_name\n" + "".join(
            f"{c},/m/{c},Sound {c}\n" for c in range(4)))
    (meta / "esc50_fold-1.json").write_text(json.dumps(
        [{"uniq_id": i, "audio_path": p, "text": f"t{i}", "class_label": i % 4}
         for i, p in enumerate(paths)]))
    (meta / "esc50_label.json").write_text(json.dumps(
        {str(c): [f"class {c}"] for c in range(4)}))
    tsv = ["uniq_id\taudio\ttext\tduration"] + [
        f"{10 + i}\t{p}\ta sound number {i}\t5.0" for i, p in enumerate(paths)]
    for split in ("train", "test"):
        (meta / f"audiocaps_{split}_new.tsv").write_text("\n".join(tsv))
    (meta / "audiocaps_test_texts.json").write_text(json.dumps(
        {str(10 + i): [f"a sound number {i}", f"another caption {i}"]
         for i in range(n)}))
    (meta / "vggsound_audio-only_val.json").write_text(json.dumps(
        [{"audio_path": p, "label_indices": i % 3} for i, p in enumerate(paths)]))
    (meta / "vggsound_stat.csv").write_text("dog barking,10\ncar,5\nrain,3\n")
    return meta


@pytest.fixture
def audio_env(tmp_path, monkeypatch):
    meta = _audio_fixture(tmp_path)
    monkeypatch.setenv("VITLENS_AUDIO_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("VITLENS_METADATA_DIR", str(tmp_path / "meta"))
    return meta


PK = dict(target_length=128, mel_bins=32)


@pytest.mark.parametrize("spec,train", [
    ("esc50@fold-1", False), ("audioset@train", True),
    ("audioset@train", False), ("audiocaps@test", False),
    ("audiocaps@train", True), ("vggsound@val", False)])
def test_audio_datasets(audio_env, spec, train):
    kw = dict(train=train, proc_kwargs=PK,
              aug_kwargs={"freq_mask": 8, "time_mask": 16} if train else None)
    (pds,), (jds,) = (PD.create_audio_datasets(spec, **kw),
                      JD.create_audio_datasets(spec, **kw))
    assert type(pds).__name__ == type(jds).__name__
    assert pds.eval_metric == jds.eval_metric
    assert pds.classnames == jds.classnames if hasattr(jds, "classnames") else True
    if hasattr(jds, "texts"):
        assert pds.texts == jds.texts and pds.text_ids == jds.text_ids
    # twice through: the train items draw mixup partners, clip windows,
    # SpecAugment masks and captions from the dataset's stream
    _items(pds, jds, list(range(len(jds))) * 2)


def test_audio_templates(audio_env):
    (pds,), (jds,) = (PD.create_audio_datasets("esc50@fold-1"),
                      JD.create_audio_datasets("esc50@fold-1"))
    names = ["Dog", "a car horn"]
    from vitlens_tpu.eval.metadata import expand_templates as je
    from vitlens_tpu_torch.eval.metadata import expand_templates as pe

    assert [pe(pds.templates, c) for c in names] == [
        je(jds.templates, c) for c in names]


def _png(path, rng, size=(40, 30), mode="RGB"):
    shape = (size[1], size[0], 3) if mode == "RGB" else (size[1], size[0])
    Image.fromarray(rng.randint(0, 255, shape, np.uint8), mode).save(path)


def test_rgbd_datasets(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    meta = tmp_path / "meta" / "modal_depth" / "data"
    meta.mkdir(parents=True)
    anno = []
    for i in range(4):
        np.save(tmp_path / f"d{i}.npy", rng.rand(30, 40).astype(np.float32) * 10)
        if i != 2:  # one sample without its image
            _png(tmp_path / f"i{i}.png", rng)
        anno.append({"image_path": f"i{i}.png", "disparity_path": f"d{i}.npy",
                     "label": "x", "cleaned_label": ["bedroom", "kitchen"][i % 2]})
    (meta / "SUN-RGBD_val.json").write_text(json.dumps(anno))
    (meta / "SUN-RGBD_train.json").write_text(json.dumps(anno))
    monkeypatch.setenv("VITLENS_DEPTH_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("VITLENS_METADATA_DIR", str(tmp_path / "meta"))
    for spec in ("sun-rgbd@val", "sun-rgbd@train"):
        (pds,), (jds,) = (PD.create_rgbd_datasets(spec, image_size=28),
                          JD.create_rgbd_datasets(spec, image_size=28))
        assert pds.classnames == jds.classnames
        _items(pds, jds, [i for i in (0, 1, 2, 3, 5, 7) if i < len(jds)])


@pytest.mark.parametrize("split", ["test_material", "train_rough", "pretrain"])
def test_tag_dataset(tmp_path, monkeypatch, split):
    rng = np.random.RandomState(1)
    meta = tmp_path / "meta" / "modal_tactile" / "data"
    meta.mkdir(parents=True)
    anno = []
    for i in range(3):
        _png(tmp_path / f"g{i}.png", rng)
        _png(tmp_path / f"v{i}.png", rng)
        anno.append({"gel_path": f"g{i}.png",
                     "image_path": f"v{i}.png" if i else "",
                     "material_label": i, "sr_label": i % 2, "hs_label": 1})
    for f in ("test.json", "train_rough.json", "pretrain.json"):
        (meta / f).write_text(json.dumps(anno))
    monkeypatch.setenv("VITLENS_TACTILE_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("VITLENS_METADATA_DIR", str(tmp_path / "meta"))
    pds = PD.TAGDataset(split=split, image_size=28, n_repeat_train=2)
    jds = JD.TAGDataset(split=split, image_size=28, n_repeat_train=2)
    assert pds.classnames == jds.classnames
    _items(pds, jds)


def test_eeg_dataset(tmp_path, monkeypatch):
    rng = np.random.RandomState(2)
    dataset = [{"eeg": torch.from_numpy(rng.randn(128, t).astype(np.float32)),
                "label": i % 2, "image": i % 3}
               for i, t in enumerate((500, 440, 520, 600, 610))]
    torch.save({"dataset": dataset, "labels": ["n01", "n02"],
                "images": ["n01_1", "n02_2", "n01_3"]},
               tmp_path / "eeg_5_95_std.pth")
    torch.save({"splits": [{"val": [0, 1, 2, 3, 4], "train": [0, 2, 4]}]},
               tmp_path / "block_splits_by_image_all.pth")
    (tmp_path / "imageNet_images" / "n01").mkdir(parents=True)
    img = Image.fromarray(rng.randint(0, 255, (30, 40, 3), np.uint8))
    img.save(tmp_path / "imageNet_images" / "n01" / "n01_1.JPEG", format="JPEG")
    meta = tmp_path / "meta" / "modal_eeg" / "data"
    meta.mkdir(parents=True)
    (meta / "imagenet_cls_mapping.json").write_text(json.dumps(
        {"n01": ["goldfish"], "n02": ["shark"]}))
    monkeypatch.setenv("VITLENS_EEG_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("VITLENS_METADATA_DIR", str(tmp_path / "meta"))
    for split in ("val", "train"):
        pds = PD.EEGDataset(split=split, image_size=28, n_repeat_train=2)
        jds = JD.EEGDataset(split=split, image_size=28, n_repeat_train=2)
        assert pds.classnames == jds.classnames
        _items(pds, jds)


@pytest.mark.parametrize("train", [False, True])
def test_video_dataset(tmp_path, monkeypatch, train):
    rng = np.random.RandomState(3)
    anno = []
    for v in range(3):
        d = tmp_path / f"vid{v}"
        d.mkdir()
        for f in range(5 + v):
            _png(d / f"{f:03d}.jpg", rng)
        anno.append({"video_path": f"vid{v}", "text": f"a video {v}" if v else "",
                     "label": ["cat", "dog"][v % 2]})
    path = tmp_path / "anno.json"
    path.write_text(json.dumps(anno))
    monkeypatch.setenv("VITLENS_VIDEO_DATA_DIR", str(tmp_path))
    kw = dict(anno_path=str(path), n_frames=4, image_size=28, train=train)
    pds, jds = PD.VideoDataset(**kw), JD.VideoDataset(**kw)
    assert (pds.classnames, pds.texts, pds.text_ids, pds.eval_metric) == (
        jds.classnames, jds.texts, jds.text_ids, jds.eval_metric)
    _items(pds, jds, [0, 1, 2, 0])


def _pc_env(tmp_path, monkeypatch):
    meta = tmp_path / "meta" / "modal_3d" / "data"
    meta.mkdir(parents=True)
    (meta / "templates.json").write_text(json.dumps(
        {"modelnet40_64": ["a point cloud of {}.", "a 3D model of a {}."],
         "shapenet_64": ["a shape of {}.", "an object: {}"]}))
    monkeypatch.setenv("VITLENS_PC_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("VITLENS_METADATA_DIR", str(tmp_path / "meta"))


@pytest.mark.parametrize("layout", ["dat", "txt"])
def test_modelnet_dataset(tmp_path, monkeypatch, layout):
    _pc_env(tmp_path, monkeypatch)
    rng = np.random.RandomState(4)
    (tmp_path / "modelnet40_shape_names.txt").write_text("chair\ntable\n")
    clouds = [rng.randn(300 + 50 * i, 6).astype(np.float32) for i in range(3)]
    if layout == "dat":
        with open(tmp_path / "modelnet40_test_256pts_fps.dat", "wb") as f:
            pickle.dump(([c[:256] for c in clouds],
                         [np.array([i % 2]) for i in range(3)]), f)
    else:
        ids = [f"{['chair', 'table'][i % 2]}_{i:04d}" for i in range(3)]
        (tmp_path / "modelnet40_test.txt").write_text("\n".join(ids))
        for i, c in zip(ids, clouds):
            (tmp_path / i.rsplit("_", 1)[0]).mkdir(exist_ok=True)
            np.savetxt(tmp_path / i.rsplit("_", 1)[0] / f"{i}.txt", c,
                       delimiter=",")
    pds, jds = PD.ModelNetDataset(npoints=256), JD.ModelNetDataset(npoints=256)
    assert (pds.classnames, pds.templates) == (jds.classnames, jds.templates)
    _items(pds, jds)


def test_scanobjectnn_dataset(tmp_path, monkeypatch):
    import h5py

    _pc_env(tmp_path, monkeypatch)
    rng = np.random.RandomState(5)
    (tmp_path / "scanobjectnn").mkdir()
    with h5py.File(tmp_path / "scanobjectnn" / "test_objectdataset.h5", "w") as f:
        f["data"] = rng.randn(3, 200, 3).astype(np.float32)
        f["label"] = np.array([1, 4, 7])
    for n in (128, 500):  # cut and tiled
        _items(PD.ScanObjectNNDataset(npoints=n), JD.ScanObjectNNDataset(npoints=n))


def _jpeg(rng):
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("layout", ["lmdb", "pkl"])
def test_objaverse_dataset(tmp_path, monkeypatch, layout):
    """Two buckets of (pc, [jpeg bytes], [[captions]]) entries: LMDB files
    written by the JAX package's write_lmdb, or pickle-per-entry
    directories."""
    _pc_env(tmp_path, monkeypatch)
    rng = np.random.RandomState(6)
    root = tmp_path / "ulip_batches"
    root.mkdir()
    for b, n in ((0, 3), (1, 2)):
        entries = [pickle.dumps((rng.randn(256, 3).astype(np.float32),
                                 [_jpeg(rng), _jpeg(rng)],
                                 [[f"b{b}e{e} view0 cap{c}" for c in range(2)],
                                  [f"b{b}e{e} view1"]]))
                   for e in range(n)]
        if layout == "lmdb":
            JL.write_lmdb(str(root / f"bucket_{b}"),
                          {str(e).encode("ascii"): v for e, v in enumerate(entries)})
        else:
            (root / f"bucket_{b}").mkdir()
            for e, v in enumerate(entries):
                (root / f"bucket_{b}" / f"{e}.pkl").write_bytes(v)
    for augment in (True, False):
        pds = PD.ObjaverseDataset(augment=augment, image_size=28)
        jds = JD.ObjaverseDataset(augment=augment, image_size=28)
        _items(pds, jds, [0, 4, 2, 3, 1])


def test_pc_triplet_dataset(tmp_path, monkeypatch):
    _pc_env(tmp_path, monkeypatch)
    rng = np.random.RandomState(7)
    anno = []
    for i, n in enumerate((400, 100, 256)):  # sampled, tiled, exact
        np.save(tmp_path / f"p{i}.npy", rng.randn(n, 6).astype(np.float32))
        if i != 1:
            _png(tmp_path / f"r{i}.png", rng)
        anno.append({"pc_path": f"p{i}.npy", "image_path": f"r{i}.png",
                     **({"caption": f"thing {i}"} if i else {"name": "chair"})})
    path = tmp_path / "triplets.json"
    path.write_text(json.dumps(anno))
    for augment in (True, False):
        kw = dict(anno_path=str(path), npoints=256, augment=augment,
                  image_size=28)
        _items(PD.PCTripletDataset(**kw), JD.PCTripletDataset(**kw), [0, 1, 2, 1])


def test_missing_roots_raise(tmp_path, monkeypatch):
    for name in ("AUDIO", "PC"):
        monkeypatch.delenv(f"VITLENS_{name}_DATA_DIR", raising=False)
        with pytest.raises(FileNotFoundError, match=f"VITLENS_{name}_DATA_DIR"):
            PD._env_root(name)
    monkeypatch.delenv("VITLENS_METADATA_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="VITLENS_METADATA_DIR"):
        PD.ESC50Dataset()
    (tmp_path / "modal_audio" / "data").mkdir(parents=True)
    monkeypatch.setenv("VITLENS_METADATA_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="unknown audio dataset"):
        PD.create_audio_datasets("nosuch@x")
