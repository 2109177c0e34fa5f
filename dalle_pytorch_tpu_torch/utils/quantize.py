"""The serving cast (counterpart of ``prepare_for_serving`` in
``dalle_pytorch_tpu/utils/quantize.py``, without its int8 path).

JAX's serving transform clones the DALLE to compute in bfloat16 and casts
every float32 parameter to bfloat16 (decode reads every weight each
step). The port's bfloat16 DALLE keeps its LayerNorm and LayerScale
parameters in float32 storage (``models/dalle.py``), so their values are
rounded through bfloat16 instead: the served model computes JAX's served
function. Weight-only int8 (``int8=True``, JAX's ``quantize_dalle``) is
ROADMAP.md queue 1 item 6.
"""

from __future__ import annotations

import torch

from ..models.dalle import DALLE


def prepare_for_serving(dalle: DALLE, int8: bool = False) -> DALLE:
    """A new DALLE computing in bfloat16 whose every parameter is
    ``dalle``'s rounded to bfloat16, on ``dalle``'s device."""
    if int8:
        raise NotImplementedError("int8 serving (quantize_dalle) is not ported "
                                  "(ROADMAP.md queue 1 item 6)")
    from ..models.factory import _load_into, build_dalle, dalle_config

    cfg = {**dalle_config(dalle), "dtype": "bfloat16", "param_dtype": "bfloat16"}
    served = build_dalle(cfg, device=dalle.device)
    _load_into(served, {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                        for k, v in dalle.state_dict().items()})
    return served.eval()
