"""JAX params -> torch ``state_dict`` for the port's models.

``flat`` is the JAX package's flat-key format (``save_params_npz``): keys
such as ``params/dce/e_conv1/depthwise/kernel`` mapped to numpy arrays. The
state_dict keys are the reference torch names (``e_convN.weight`` for
zero_dce_re; ``e_convN.dw_conv.weight`` and ``e_convN.pw_conv.weight`` for
zero_dce++), so the result loads with ``load_state_dict`` into the port's
module, and a released ``.pth`` loads into it as it is.

Layouts: a conv kernel HWIO (k,k,I,O) -> OIHW; depthwise (k,k,1,C) ->
(C,1,k,k); pointwise (1,1,I,O) -> (O,I,1,1); a bias (O,) stays. An
unmatched key or a mis-shaped array raises.
"""

from __future__ import annotations

import numpy as np
import torch

from enhax_torch.constants import MODELS


# The inverse of the JAX package's torch->flax name maps for Zero-DCE: plain
# keys are prefix rewrites, keys starting with "*" substring rewrites.
def zero_dce_name_map() -> dict:
    """enhax ``dce.e_convN.*`` -> reference ``e_convN.*``."""
    return {f"dce.e_conv{i}.": f"e_conv{i}." for i in range(1, 8)}


def zero_dcepp_name_map() -> dict:
    """As zero_dce, plus DSConv's ``depthwise``/``pointwise`` ->
    ``dw_conv``/``pw_conv``."""
    m = zero_dce_name_map()
    m["*.depthwise."] = ".dw_conv."
    m["*.pointwise."] = ".pw_conv."
    return m


_NAME_MAPS = {
    "zero_dce_re": zero_dce_name_map,
    "zero_dce++_re": zero_dcepp_name_map,
}


def _rename(key: str, name_map: dict) -> str | None:
    """Flax dotted key -> torch key, or None when no prefix rule matches."""
    for old, new in name_map.items():
        if not old.startswith("*") and key.startswith(old):
            key = new + key[len(old):]
            break
    else:
        return None
    for old, new in name_map.items():
        if old.startswith("*"):
            key = key.replace(old[1:], new)
    leaf = key.rsplit(".", 1)
    if leaf[-1] == "kernel":
        return leaf[0] + ".weight"
    if leaf[-1] == "bias":
        return key
    return None


def _convert(key: str, arr: np.ndarray) -> np.ndarray:
    if key.endswith(".bias"):
        if arr.ndim != 1:
            raise ValueError(f"{key}: a bias must be 1-D, got shape {arr.shape}")
        return arr
    if arr.ndim != 4 or arr.shape[0] != arr.shape[1]:
        raise ValueError(f"{key}: expected a square HWIO conv kernel, got shape {arr.shape}")
    if ".dw_conv." in key:
        if arr.shape[2] != 1:
            raise ValueError(f"{key}: a depthwise kernel is (k,k,1,C), got {arr.shape}")
    elif ".pw_conv." in key:
        if arr.shape[:2] != (1, 1):
            raise ValueError(f"{key}: a pointwise kernel is (1,1,I,O), got {arr.shape}")
    return arr.transpose(3, 2, 0, 1)


def jax_to_torch_state_dict(model_name: str, flat: dict) -> dict[str, torch.Tensor]:
    """Convert the JAX package's flat params of ``model_name`` to the port's
    ``state_dict``."""
    canonical = MODELS.canonical_name(model_name)
    if canonical not in _NAME_MAPS:
        raise KeyError(f"no JAX->torch name map for model {model_name!r}")
    name_map = _NAME_MAPS[canonical]()
    out: dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        dotted = key.replace("/", ".")
        if dotted.startswith("params."):
            dotted = dotted[len("params."):]
        tkey = _rename(dotted, name_map)
        if tkey is None:
            raise KeyError(f"{model_name}: JAX param {key!r} matches no rule of the name map")
        a = _convert(tkey, np.asarray(arr))
        out[tkey] = torch.tensor(a)
    for key, w in out.items():
        if key.endswith(".weight"):
            b = out.get(key[: -len("weight")] + "bias")
            if b is not None and b.shape[0] != w.shape[0]:
                raise ValueError(f"{key}: {w.shape[0]} output channels but its bias "
                                 f"has {b.shape[0]}")
    return out
