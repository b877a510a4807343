"""JAX params -> torch ``state_dict`` for the port's models.

``flat`` is the JAX package's flat-key format (``save_params_npz``): keys
such as ``params/dce/e_conv1/depthwise/kernel`` mapped to numpy arrays. The
state_dict keys are the reference torch names (``e_convN.weight`` for
zero_dce_re; ``e_convN.dw_conv.weight`` and ``e_convN.pw_conv.weight`` for
zero_dce++; ``encoders.i.j.conv1.weight`` and so on for NAFNet;
``encoder_level1.j.attn.qkv.weight`` and so on for Restormer;
``down_path_1.i.conv_1.weight`` and so on for HINet), so the
result loads with ``load_state_dict`` into the port's module, and a released
``.pth`` loads into it as it is.

Layouts: a conv kernel HWIO (kh,kw,I,O) -> OIHW; depthwise (k,k,1,C) ->
(C,1,k,k); pointwise (1,1,I,O) -> (O,I,1,1); a Dense kernel (I,O) ->
(O,I,1,1); flax's ``ConvTranspose(transpose_kernel=True)`` kernel
(kh,kw,O,I) -> torch's (I,O,kh,kw), no spatial flip (the conv's own
transpose); a LayerNorm or InstanceNorm ``scale`` (C,) -> ``weight``; NAFNet's ``beta`` and
``gamma`` (1,1,1,C) -> (1,C,1,1); Restormer's ``temperature`` (heads,1,1)
and a bias (O,) stay. An unmatched key or a mis-shaped array raises.
"""

from __future__ import annotations

import re

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


def nafnet_name_map(enc_blk_nums=(2, 2, 4, 8), middle_blk_num: int = 12,
                    dec_blk_nums=(2, 2, 2, 2)) -> dict:
    """enhax ``enc{i}_{j}``, ``down{i}``, ``mid_{j}``, ``up{i}``,
    ``dec{i}_{j}`` -> NAFNet_arch.py's ``encoders.i.j``, ``downs.i``,
    ``middle_blks.j``, ``ups.i.0``, ``decoders.i.j``; ``sca`` -> ``sca.1``."""
    m = {"intro.": "intro.", "ending.": "ending."}
    for i, n in enumerate(enc_blk_nums):
        for j in range(n):
            m[f"enc{i}_{j}."] = f"encoders.{i}.{j}."
        m[f"down{i}."] = f"downs.{i}."
    for j in range(middle_blk_num):
        m[f"mid_{j}."] = f"middle_blks.{j}."
    for i, n in enumerate(dec_blk_nums):
        m[f"up{i}."] = f"ups.{i}.0."
        for j in range(n):
            m[f"dec{i}_{j}."] = f"decoders.{i}.{j}."
    m["*.sca."] = ".sca.1."
    return m


def _nafnet_depths(keys) -> tuple:
    """(enc_blk_nums, middle_blk_num, dec_blk_nums) as the keys name them."""
    enc, dec, mid = {}, {}, 0
    for key in keys:
        if m := re.match(r"(enc|dec)(\d+)_(\d+)\.", key):
            d = enc if m[1] == "enc" else dec
            d[int(m[2])] = max(d.get(int(m[2]), 0), int(m[3]) + 1)
        elif m := re.match(r"mid_(\d+)\.", key):
            mid = max(mid, int(m[1]) + 1)
        elif m := re.match(r"(down|up)(\d+)\.", key):
            d = enc if m[1] == "down" else dec
            d.setdefault(int(m[2]), 0)
    return ([enc.get(i, 0) for i in range(max(enc, default=-1) + 1)], mid,
            [dec.get(i, 0) for i in range(max(dec, default=-1) + 1)])


def restormer_name_map(num_blocks=(4, 6, 6, 8), num_refinement: int = 4) -> dict:
    """enhax ``embed``, ``enc{l}_{j}``, ``dec{l}_{j}``, ``down{l}``,
    ``up{l}``, ``latent_{j}``, ``reduce{1,2}``, ``refine_{j}`` ->
    restormer_arch.py's ``patch_embed.proj``, ``encoder_level{l+1}.j``, ...;
    inside a block ``norm1``/``norm2`` -> ``norm1.body``/``norm2.body`` and
    ``qkv_dw`` -> ``qkv_dwconv``."""
    m = {"embed.": "patch_embed.proj.", "output.": "output."}
    for lvl in range(3):
        for j in range(num_blocks[lvl]):
            m[f"enc{lvl}_{j}."] = f"encoder_level{lvl + 1}.{j}."
            m[f"dec{lvl}_{j}."] = f"decoder_level{lvl + 1}.{j}."
        m[f"down{lvl}."] = f"down{lvl + 1}_{lvl + 2}.body.0."
        m[f"up{lvl}."] = f"up{lvl + 2}_{lvl + 1}.body.0."
    for j in range(num_blocks[3]):
        m[f"latent_{j}."] = f"latent.{j}."
    m["reduce2."] = "reduce_chan_level3."
    m["reduce1."] = "reduce_chan_level2."
    for j in range(num_refinement):
        m[f"refine_{j}."] = f"refinement.{j}."
    m["*.norm1."] = ".norm1.body."
    m["*.norm2."] = ".norm2.body."
    m["*.qkv_dw."] = ".qkv_dwconv."
    return m


def _restormer_depths(keys) -> tuple:
    """(num_blocks, num_refinement) as the keys name them."""
    counts = {}
    for key in keys:
        if m := re.match(r"(?:enc|dec)(\d+)_(\d+)\.", key):
            lvl = int(m[1])
        elif m := re.match(r"(latent|refine)_(\d+)\.", key):
            lvl = m[1]
        else:
            continue
        counts[lvl] = max(counts.get(lvl, 0), int(m[2]) + 1)
    return (tuple(counts.get(i, 0) for i in range(3)) + (counts.get("latent", 0),),
            counts.get("refine", 0))


def hinet_name_map(depth: int = 5) -> dict:
    """enhax ``down{s}_{i}``, ``up{s}_{i}``, ``skip{s}_{i}`` ->
    hinet_arch.py's ``down_path_{s}.i``, ``up_path_{s}.i``,
    ``skip_conv_{s}.i``; a block's ``down`` -> ``downsample`` (the inverse
    of ``enhax/convert/mappings.py::hinet_name_map``)."""
    m = {"conv_01.": "conv_01.", "conv_02.": "conv_02.", "sam12.": "sam12.",
         "cat12.": "cat12.", "last.": "last."}
    for s in (1, 2):
        for i in range(depth):
            m[f"down{s}_{i}."] = f"down_path_{s}.{i}."
        for i in range(depth - 1):
            m[f"up{s}_{i}."] = f"up_path_{s}.{i}."
            m[f"skip{s}_{i}."] = f"skip_conv_{s}.{i}."
    m["*.down."] = ".downsample."
    return m


def _hinet_depth(keys) -> int:
    """The depth as the keys name it: the stage-1 encoder blocks."""
    return 1 + max(int(m[1]) for key in keys if (m := re.match(r"down1_(\d+)\.", key)))


_NAME_MAPS = {
    "zero_dce_re": lambda keys: zero_dce_name_map(),
    "zero_dce++_re": lambda keys: zero_dcepp_name_map(),
    "nafnet": lambda keys: nafnet_name_map(*_nafnet_depths(keys)),
    "nafnet_local": lambda keys: nafnet_name_map(*_nafnet_depths(keys)),
    "restormer": lambda keys: restormer_name_map(*_restormer_depths(keys)),
    "hinet_re": lambda keys: hinet_name_map(_hinet_depth(keys)),
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
    if leaf[-1] in ("kernel", "scale"):
        return leaf[0] + ".weight"
    if leaf[-1] in ("bias", "beta", "gamma", "temperature"):
        return key
    return None


# HINet's ``up_path_{s}.i.up``: the one transposed conv of the mapped models
_TRANSPOSED = re.compile(r"(^|\.)up\.weight$")


def _convert(key: str, arr: np.ndarray) -> np.ndarray:
    if key.endswith(".temperature"):
        if arr.ndim != 3 or arr.shape[1:] != (1, 1):
            raise ValueError(f"{key}: expected (heads,1,1), got shape {arr.shape}")
        return arr
    if key.endswith(".bias") or re.search(r"(^|\.)norm\d*(\.body)?\.weight$", key):
        if arr.ndim != 1:
            raise ValueError(f"{key}: a bias or LayerNorm scale must be 1-D, got "
                             f"shape {arr.shape}")
        return arr
    if key.endswith((".beta", ".gamma")):
        if arr.ndim != 4 or arr.shape[:3] != (1, 1, 1):
            raise ValueError(f"{key}: expected (1,1,1,C), got shape {arr.shape}")
        return arr.transpose(0, 3, 1, 2)
    if arr.ndim == 2:  # a Dense kernel (I, O): a 1x1 conv's weight
        return arr.T[:, :, None, None]
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
    dotted_keys = {}
    for key in flat:
        dotted = key.replace("/", ".")
        dotted_keys[key] = dotted[len("params."):] if dotted.startswith("params.") else dotted
    name_map = _NAME_MAPS[canonical](list(dotted_keys.values()))
    out: dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        tkey = _rename(dotted_keys[key], name_map)
        if tkey is None:
            raise KeyError(f"{model_name}: JAX param {key!r} matches no rule of the name map")
        a = _convert(tkey, np.asarray(arr))
        out[tkey] = torch.tensor(a)
    for key, w in out.items():
        if key.endswith(".weight"):
            b = out.get(key[: -len("weight")] + "bias")
            # a transposed conv's (I, O, kh, kw) weight has its outputs second
            n_out = w.shape[1] if _TRANSPOSED.search(key) else w.shape[0]
            if b is not None and b.shape[0] != n_out:
                raise ValueError(f"{key}: {n_out} output channels but its bias "
                                 f"has {b.shape[0]}")
    return out
