"""HuggingFace text encoder (port of vitlens_tpu/models/hf_text.py).

Wraps a transformers AutoModel as a text tower with a pooler (cls / mean /
cls-last-hidden-state) and a linear or MLP projection to embed_dim. The
weights need a local ``model_path`` (a save_pretrained directory) where
there is no network; construction raises a clear error otherwise.
transformers is imported at construction. The encoder runs on ``device``
(the card unless the caller passes ``device="cpu"``) and returns numpy; the
projection is drawn from a ``torch.Generator`` seeded with ``seed``, with
``nn.Linear``'s default distribution. What the build draws from the global
generators (with ``pretrained=False`` the transformer's fresh weights) is
drawn inside ``torch.random.fork_rng`` from generators seeded with ``seed``:
the caller's RNG state is left as it was. The BERT family also runs as a native
tower through ``models/bert_text.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


class HFTextEncoder:
    """pooler_type in {cls_pooler, mean_pooler, cls_last_hidden_state_pooler};
    proj in {linear, mlp} (reference hf_model.py ClsPooler/MeanPooler and
    proj construction)."""

    def __init__(self, model_name_or_path: str, output_dim: int,
                 pooler_type: str = "mean_pooler", proj: str = "linear",
                 pretrained: bool = True, *, device=None, seed: int = 0):
        try:
            import torch
            import torch.nn as nn
            import transformers  # noqa: F401
        except ImportError as e:  # pragma: no cover
            raise ImportError("transformers required for HFTextEncoder") from e
        from vitlens_tpu_torch.factory import make_generator, resolve_device

        self.torch = torch
        self.device = resolve_device(device)
        # transformers draws fresh weights (all of them with
        # pretrained=False) and nn.Linear its default init from the global
        # generators: seed them from ``seed`` inside a fork, so the build is
        # reproducible and leaves the caller's RNG state as it was
        cuda = ([self.device.index if self.device.index is not None
                 else torch.cuda.current_device()]
                if self.device.type == "cuda" else [])
        with torch.random.fork_rng(devices=cuda):
            torch.random.default_generator.manual_seed(seed)
            for i in cuda:
                torch.cuda.default_generators[i].manual_seed(seed)
            self._build(model_name_or_path, output_dim, proj, pretrained)
        self.pooler_type = pooler_type
        g = make_generator(seed, self.device)
        with torch.no_grad():
            for m in self.proj.modules():
                if isinstance(m, nn.Linear):
                    bound = 1.0 / math.sqrt(m.in_features)
                    m.weight.uniform_(-bound, bound, generator=g)
        self.proj.eval()

    def _build(self, model_name_or_path, output_dim, proj, pretrained):
        """The transformer (on ``self.device``, in eval mode) and the
        projection, as constructed (the caller redraws the projection)."""
        import torch.nn as nn
        from transformers import AutoConfig, AutoModel

        if pretrained:
            try:
                self.transformer = AutoModel.from_pretrained(model_name_or_path)
            except Exception as e:
                raise RuntimeError(
                    f"could not load HF weights for {model_name_or_path!r} "
                    "(offline environment?); pass a local path"
                ) from e
        else:
            cfg = AutoConfig.from_pretrained(model_name_or_path)
            self.transformer = AutoModel.from_config(cfg)
        self.transformer.to(self.device).eval()
        d_model = self.transformer.config.hidden_size
        if proj == "linear":
            self.proj = nn.Linear(d_model, output_dim, bias=False,
                                  device=self.device)
        else:  # mlp
            hidden = (d_model + output_dim) // 2
            self.proj = nn.Sequential(
                nn.Linear(d_model, hidden, bias=False, device=self.device),
                nn.GELU(),
                nn.Linear(hidden, output_dim, bias=False, device=self.device),
            )

    def _pool(self, out, attention_mask):
        h = out.last_hidden_state
        if self.pooler_type == "cls_pooler":
            if hasattr(out, "pooler_output") and out.pooler_output is not None:
                return out.pooler_output
            return h[:, 0]
        if self.pooler_type == "cls_last_hidden_state_pooler":
            return h[:, 0]
        # mean pooler with mask
        m = attention_mask.unsqueeze(-1).to(h.dtype)
        return (h * m).sum(1) / m.sum(1).clamp(min=1)

    def encode(self, input_ids: np.ndarray,
               attention_mask: Optional[np.ndarray] = None) -> np.ndarray:
        torch = self.torch
        ids = torch.from_numpy(np.asarray(input_ids)).long().to(self.device)
        if attention_mask is None:
            attention_mask = (ids != 0).long()
        else:
            attention_mask = torch.from_numpy(
                np.asarray(attention_mask)).long().to(self.device)
        with torch.no_grad():
            out = self.transformer(input_ids=ids, attention_mask=attention_mask)
            pooled = self._pool(out, attention_mask)
            return self.proj(pooled).cpu().numpy()
