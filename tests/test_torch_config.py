"""The port's copy of the config tree equals the JAX package's, field by
field, for every arch in the registry and both the audio and image presets."""

import dataclasses

import pytest

from vitlens_tpu import config as JC
from vitlens_tpu_torch import config as PC
from tests.test_torch_threads import share_cores

share_cores()


@pytest.mark.parametrize("modality", ["audio", "image"])
@pytest.mark.parametrize("arch", sorted(JC.ARCH_REGISTRY))
def test_model_config_equal(arch, modality):
    assert sorted(PC.ARCH_REGISTRY) == sorted(JC.ARCH_REGISTRY)
    want = dataclasses.asdict(JC.make_model_config(arch, modality))
    got = dataclasses.asdict(PC.make_model_config(arch, modality))
    assert got == want
    assert (dataclasses.asdict(PC.image_tower_config(PC.make_model_config(arch, modality)))
            == dataclasses.asdict(JC.image_tower_config(JC.make_model_config(arch, modality))))
