"""chip_smoke.py's fp32 reference (``Fp32Reference``, ``tf32_off``,
``host_fps``) and its phase clock, on the CPU: the copy's weights equal the
source's in fp32, the source model is untouched, the TF32 flags come back
as they were (after an exception too), FPS swapped to the host gives the
wrapper's indices and is swapped back, and the clock's table adds up its
phases and leaves out spans in other threads. The card path (TF32 off,
zero launches) runs only in chip_smoke.py."""

import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from vitlens_tpu_torch.config import make_model_config
from vitlens_tpu_torch.factory import cast_matmul_weights_, make_generator
from vitlens_tpu_torch.models.text import TextTower
from vitlens_tpu_torch.ops import fps as F
from tests.test_torch_threads import share_cores

share_cores()


def _bf16_tower():
    cfg = make_model_config("ViT-Tiny-Test", "audio")
    tower = TextTower(cfg.text, cfg.embed_dim, device="cpu")
    tower.init_(make_generator(0, "cpu"))
    cast_matmul_weights_(tower, torch.bfloat16)
    return tower


def test_reference_copies_in_fp32_and_leaves_the_source():
    tower = _bf16_tower()
    before = {n: (t.dtype, t.device, t.detach().clone())
              for n, t in tower.state_dict().items()}
    assert any(d == torch.bfloat16 for d, _, _ in before.values())
    ref = chip_smoke.Fp32Reference(torch, chip_smoke.launch_counters(), tower, "cpu")
    copy = ref.model.state_dict()
    for n, (dtype, device, value) in before.items():
        if value.is_floating_point():
            assert copy[n].dtype == torch.float32, n
            assert torch.equal(copy[n], value.float()), n
        else:
            assert torch.equal(copy[n], value), n
        now = tower.state_dict()[n]
        assert (now.dtype, now.device) == (dtype, device), n
        assert torch.equal(now, value), n
    assert copy["token_embedding"].data_ptr() != tower.token_embedding.data_ptr()
    n = tower.positional_embedding.shape[0]
    ids = torch.from_numpy(np.random.RandomState(0).randint(1, 60, (2, n)))
    got = ref(lambda m: m(ids, torch.float32))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert ref.note == "fp32 plain path on the CPU"


@pytest.mark.parametrize("start", [(True, True), (False, False), (True, False)])
def test_tf32_flags_restored(start):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = start
        with chip_smoke.tf32_off(torch):
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == start
        with pytest.raises(RuntimeError):
            with chip_smoke.tf32_off(torch):
                raise RuntimeError("inside")
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == start
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_host_fps_gives_the_wrappers_indices_and_swaps_back():
    xyz = torch.from_numpy(np.random.RandomState(1).randn(2, 300, 3)
                           .astype(np.float32))
    start = torch.tensor([5, 17], dtype=torch.int32)
    launcher = F.fps_indices
    with chip_smoke.host_fps(torch):
        assert F.fps_indices is not launcher
        got = F.fps(xyz, 32, start)
        got0 = F.fps_indices(xyz, 32)
        drawn = F.fps_indices(xyz, 32, generator=torch.Generator().manual_seed(3))
    assert F.fps_indices is launcher
    assert torch.equal(got, F.fps(xyz, 32, start))
    assert torch.equal(got0, F.fps_indices(xyz, 32))
    assert torch.equal(drawn, F.fps_indices(
        xyz, 32, generator=torch.Generator().manual_seed(3)))


def test_phase_clock_table_adds_up(capsys):
    clock = chip_smoke.PhaseClock()
    with chip_smoke.spent("ref"):
        with chip_smoke.spent("ref"):  # nested: counted once
            time.sleep(0.05)
    chip_smoke.spends("proc")(time.sleep)(0.05)
    clock.mark("one")
    # a span in another thread counts nowhere: its wait does, as a Background's
    other = threading.Thread(target=chip_smoke.spends("build")(time.sleep),
                             args=(0.05,))
    other.start()
    other.join(timeout=30)
    assert not other.is_alive()
    clock.mark("two")
    clock.table()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[time] one done at ") and "'ref': 0.1" in out[0]
    rows = [line.split(" | ") for line in out if line.startswith("[time table]")]
    assert rows[0][1:] == ["wall", "cpu", "children", *chip_smoke.SPAN_KINDS]
    assert [r[0] for r in rows[1:]] == ["[time table] one", "[time table] two",
                                        "[time table] whole run"]
    one, two, whole = ([float(v) for v in r[1:]] for r in rows[1:])
    assert whole == pytest.approx([a + b for a, b in zip(one, two)], abs=0.15)
    assert one[3] >= 0.05 and one[4] >= 0.05 and two[3:] == [0.0] * 5

