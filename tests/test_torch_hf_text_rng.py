"""models/hf_text.py's HFTextEncoder with ``pretrained=False`` draws the
transformer's fresh weights from the global generators seeded with its
``seed`` inside ``torch.random.fork_rng``: equal seeds give equal weights,
other seeds other weights, and the caller's RNG state is left as it was."""

import torch
import transformers

from vitlens_tpu_torch.models.hf_text import HFTextEncoder
from tests.test_torch_threads import share_cores

share_cores()


def _config_dir(tmp_path):
    transformers.BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                            num_attention_heads=2, intermediate_size=64,
                            max_position_embeddings=16).save_pretrained(tmp_path)
    return str(tmp_path)


def test_fresh_weights_are_seeded_and_leave_the_global_rng(tmp_path):
    path = _config_dir(tmp_path)
    torch.manual_seed(123)
    before = torch.get_rng_state()
    a = HFTextEncoder(path, 16, pretrained=False, device="cpu", seed=3)
    assert torch.equal(torch.get_rng_state(), before)
    torch.manual_seed(99)  # another global state: the same weights
    b = HFTextEncoder(path, 16, pretrained=False, device="cpu", seed=3)
    c = HFTextEncoder(path, 16, pretrained=False, device="cpu", seed=4)
    sa, sb, sc = (m.transformer.state_dict() for m in (a, b, c))
    assert sorted(sa) == sorted(sb)
    drawn = [k for k in sa if sa[k].is_floating_point() and sa[k].std() > 0]
    assert drawn
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert any(not torch.equal(sa[k], sc[k]) for k in drawn)
