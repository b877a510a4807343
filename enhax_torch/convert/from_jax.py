"""JAX params -> torch ``state_dict`` for the port's models.

``flat`` is the JAX package's flat-key format (``save_params_npz``): keys
such as ``params/dce/e_conv1/depthwise/kernel`` mapped to numpy arrays. The
state_dict keys are the reference torch names (``e_convN.weight`` for
zero_dce_re and zero_dce_v; ``e_convN.dw_conv.weight`` and ``e_convN.pw_conv.weight`` for
zero_dce++; ``encoders.i.j.conv1.weight`` and so on for NAFNet;
``encoder_level1.j.attn.qkv.weight`` and so on for Restormer;
``down_path_1.i.conv_1.weight`` and so on for HINet;
``encoderlayer_0.j.attn.qkv.to_q.weight`` and so on for Uformer), so the
result loads with ``load_state_dict`` into the port's module, and a released
``.pth`` loads into it as it is.

The instance models (CoLIE, Zero-MIE, GCENet, RRDNet, ZSN2N, ZID) keep the
JAX package's names, but for an INR layer's inner ``Dense_0`` (``linear``
here), a DSConv's ``DSConv_0.depthwise``/``pointwise`` (``dw_conv``/
``pw_conv``) and Zero-MIE's flat ``value_net_net0`` (the ``nn.Sequential``
``value_net.0``). ZID's ``batch_stats`` (``mean``, ``var``) become its
BatchNorms' parameters of those names.

``jax_checkpoint_to_torch`` turns a JAX trainer checkpoint (params, EMA
and the optax state) into the port's ``state.pt`` payload.

Layouts: a conv kernel HWIO (kh,kw,I,O) -> OIHW; depthwise (k,k,1,C) ->
(C,1,k,k); pointwise (1,1,I,O) -> (O,I,1,1); a Dense kernel (I,O) ->
(O,I,1,1) where the port holds it as a 1x1 conv (NAFNet, Restormer, HINet)
and -> an ``nn.Linear``'s (O,I) in the instance models; flax attention's
DenseGeneral kernels (I,heads,d) and (heads,d,O) -> (heads*d, I) and
(O, heads*d), their biases flattened; Uformer's Dense kernels -> ``nn.Linear``
weights, its ``rel_pos_bias`` ((2ws-1)^2, heads) and ``modulator`` (ws^2, C)
as they are (the reference's ``relative_position_bias_table`` and
``modulator.weight``, an ``nn.Embedding``); flax's
``ConvTranspose(transpose_kernel=True)`` kernel (kh,kw,O,I) -> torch's
(I,O,kh,kw), no spatial flip (the conv's own transpose); a LayerNorm,
InstanceNorm or BatchNorm ``scale`` (C,) -> ``weight``; NAFNet's ``beta``
and ``gamma`` (1,1,1,C) -> (1,C,1,1); Restormer's ``temperature``
(heads,1,1), a bias (O,), a BatchNorm's ``mean`` and ``var``, CoLIE's
``density_k`` and Zero-MIE-MS's Fourier matrix ``B`` (F,2) stay. An
unmatched key or a mis-shaped array raises.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

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


def uformer_name_map(keys) -> dict:
    """enhax ``input_proj``, ``enc{i}_{j}``, ``down{i}``, ``mid_{j}``,
    ``up{l}``, ``dec{l}_{j}``, ``output_proj`` -> uformer.py's
    ``input_proj.proj.0``, ``encoderlayer_{i}.blocks.j``,
    ``downsample_{i}.conv.0``, ``conv.blocks.j``, ``upsample_{3-l}.deconv.0``,
    ``decoderlayer_{3-l}.blocks.j``, ``output_proj.proj.0``; inside a block
    the split projections under ``attn.qkv``, the bias table, the modulator
    at the block and the LeFF's layers under ``mlp`` (the inverse of
    ``enhax/convert/mappings.py::uformer_name_map``)."""
    m = {"input_proj.": "input_proj.proj.0.", "output_proj.": "output_proj.proj.0."}
    for key in keys:
        if b := re.match(r"(enc|dec)(\d)_(\d+)\.", key):
            lvl, j = int(b[2]), b[3]
            m[b[0]] = (f"encoderlayer_{lvl}.blocks.{j}." if b[1] == "enc"
                       else f"decoderlayer_{3 - lvl}.blocks.{j}.")
        elif b := re.match(r"mid_(\d+)\.", key):
            m[b[0]] = f"conv.blocks.{b[1]}."
    for i in range(4):
        m[f"down{i}."] = f"downsample_{i}.conv.0."
        m[f"up{i}."] = f"upsample_{3 - i}.deconv.0."
    m["*.attn.to_q."] = ".attn.qkv.to_q."
    m["*.attn.to_kv."] = ".attn.qkv.to_kv."
    m["*.attn.rel_pos_bias"] = ".attn.relative_position_bias_table"
    m["*.attn.modulator"] = ".modulator.weight"
    m["*.ffn.fc1."] = ".mlp.linear1.0."
    m["*.ffn.dwconv."] = ".mlp.dwconv.0."
    m["*.ffn.fc2."] = ".mlp.linear2.0."
    return m


def instance_name_map(keys) -> dict:
    """The instance models' map: every top-level name kept, Zero-MIE's
    ``X_net{i}`` -> ``X.{i}``; inside, ``Dense_0`` -> ``linear`` and a
    DSConv's convs -> ``dw_conv``/``pw_conv``."""
    m = {}
    for key in keys:
        head = key.split(".")[0]
        if z := re.fullmatch(r"(.+)_net(\d+)", head):
            m[head + "."] = f"{z[1]}.{z[2]}."
        else:
            m[head + ("." if "." in key else "")] = head + ("." if "." in key else "")
    m["*.Dense_0."] = ".linear."
    m["*.DSConv_0.depthwise."] = ".dw_conv."
    m["*.DSConv_0.pointwise."] = ".pw_conv."
    return m


_INSTANCE = (["gcenet", "gcenet_zsn2n", "gcenet_instance", "colie_re", "colie_hvi",
              "colie_hvid", "rrdnet_re", "zsn2n", "zid", "zero_mie", "zero_mie_rgb_d",
              "zero_mie_hsv", "zero_mie_hsv_d", "zero_mie_finer", "zero_mie_gauss",
              "zero_mie_relu", "zero_mie_ms"]
             + [f"zero_mie_ms_wo_{k}" for k in ("color", "depth", "edge", "exp", "ff", "spa",
                                                 "spar", "tv")])

_NAME_MAPS = {
    **{name: instance_name_map for name in _INSTANCE},
    "zero_dce_re": lambda keys: zero_dce_name_map(),
    "zero_dce_v": lambda keys: zero_dce_name_map(),
    "zero_dce++_re": lambda keys: zero_dcepp_name_map(),
    "nafnet": lambda keys: nafnet_name_map(*_nafnet_depths(keys)),
    "nafnet_local": lambda keys: nafnet_name_map(*_nafnet_depths(keys)),
    "restormer": lambda keys: restormer_name_map(*_restormer_depths(keys)),
    "hinet_re": lambda keys: hinet_name_map(_hinet_depth(keys)),
    **{name: uformer_name_map for name in ("uformer_re", "uformer_t", "uformer_s", "uformer_b",
                                           "uformer_noshift", "uformer_fastleff")},
}
# models whose Dense kernels are ``nn.Linear`` weights (not 1x1 convs)
_LINEAR = set(_INSTANCE) | {"uformer_re", "uformer_t", "uformer_s", "uformer_b",
                            "uformer_noshift", "uformer_fastleff"}
# leaves that keep their array as it is: a bias table, a modulator
_AS_IS = re.compile(r"\.(relative_position_bias_table|modulator\.weight)$")


# leaves kept under their own names (beside kernel/scale -> weight)
_LEAVES = ("bias", "beta", "gamma", "temperature", "mean", "var", "density_k", "B")


def _rename(key: str, name_map: dict) -> str | None:
    """Flax dotted key -> torch key, or None when no prefix rule matches."""
    for old, new in name_map.items():
        if not old.startswith("*") and (key.startswith(old) if old.endswith(".")
                                        else key == old):
            key = new + key[len(old):]
            break
    else:
        return None
    for old, new in name_map.items():
        if old.startswith("*"):
            key = key.replace(old[1:], new)
    if _AS_IS.search(key):
        return key
    leaf = key.rsplit(".", 1)
    if leaf[-1] in ("kernel", "scale"):
        return leaf[0] + ".weight"
    if leaf[-1] in _LEAVES:
        return key
    return None


# the transposed convs of the mapped models: HINet's ``up_path_{s}.i.up``,
# Uformer's ``upsample_{i}.deconv.0``
_TRANSPOSED = re.compile(r"(^|\.)(up|deconv\.0)\.weight$")
_ATTENTION = re.compile(r"\.attn\.(query|key|value|out)\.(weight|bias)$")


def _convert(key: str, arr: np.ndarray, linear: bool = False) -> np.ndarray:
    """``arr`` in the layout of the torch tensor ``key``; with ``linear`` a
    Dense kernel becomes an ``nn.Linear`` weight."""
    if key.endswith(".temperature"):
        if arr.ndim != 3 or arr.shape[1:] != (1, 1):
            raise ValueError(f"{key}: expected (heads,1,1), got shape {arr.shape}")
        return arr
    if _AS_IS.search(key):
        if arr.ndim != 2:
            raise ValueError(f"{key}: expected a 2-D table, got shape {arr.shape}")
        return arr
    if key == "B" or key.endswith(".B"):
        if arr.ndim != 2 or arr.shape[1] != 2:
            raise ValueError(f"{key}: expected a (features, 2) Fourier matrix, got {arr.shape}")
        return arr
    if linear and (a := _ATTENTION.search(key)):
        if a[2] == "bias":
            return arr.reshape(-1)
        if arr.ndim != 3:
            raise ValueError(f"{key}: expected a DenseGeneral kernel, got shape {arr.shape}")
        return (arr.reshape(-1, arr.shape[-1]) if a[1] == "out"
                else arr.reshape(arr.shape[0], -1)).T
    if (key.endswith((".bias", ".mean", ".var")) or key == "density_k"
            or re.search(r"(^|\.)(norm\d*(\.body)?|\w*_bn\d*)\.weight$", key)):
        if arr.ndim != 1:
            raise ValueError(f"{key}: a bias, a LayerNorm or BatchNorm scale or a BatchNorm "
                             f"statistic must be 1-D, got shape {arr.shape}")
        return arr
    if key.endswith((".beta", ".gamma")):
        if arr.ndim != 4 or arr.shape[:3] != (1, 1, 1):
            raise ValueError(f"{key}: expected (1,1,1,C), got shape {arr.shape}")
        return arr.transpose(0, 3, 1, 2)
    if arr.ndim == 2:  # a Dense kernel (I, O): a Linear's weight, or a 1x1 conv's
        return arr.T if linear else arr.T[:, :, None, None]
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
        for collection in ("params.", "batch_stats."):
            if dotted.startswith(collection):
                dotted = dotted[len(collection):]
        dotted_keys[key] = dotted
    name_map = _NAME_MAPS[canonical](list(dotted_keys.values()))
    linear = canonical in _LINEAR
    out: dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        tkey = _rename(dotted_keys[key], name_map)
        if tkey is None:
            raise KeyError(f"{model_name}: JAX param {key!r} matches no rule of the name map")
        a = _convert(tkey, np.asarray(arr), linear)
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


# -- a JAX trainer checkpoint -> the port's ----------------------------------

def flatten_tree(tree, prefix: str = "") -> dict:
    """A nested dict of arrays as the flat ``a/b/kernel`` keys of
    ``save_params_npz`` (the format ``jax_to_torch_state_dict`` reads)."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _fields(node):
    """The children of an optax state node: a NamedTuple's fields, a dict's
    items (orbax restores a NamedTuple without its template as one), a
    tuple's or list's entries; None for a leaf."""
    if hasattr(node, "_asdict"):
        return node._asdict()
    if isinstance(node, Mapping):
        return node
    if isinstance(node, (tuple, list)):
        return dict(enumerate(node))
    return None


def _find(node, keys: tuple) -> list:
    """Every node of an optax state tree whose fields include ``keys``."""
    fields = _fields(node)
    if fields is None:
        return []
    found = [fields] if all(k in fields for k in keys) else []
    for value in fields.values():
        found += _find(value, keys)
    return found


def jax_checkpoint_to_torch(model_name: str, payload: dict, optimizer_cfg: dict,
                            trainer_cfg: dict | None = None, model_cfg: dict | None = None) -> dict:
    """The JAX package's trainer checkpoint as the port's ``state.pt`` payload.

    ``payload`` is the tree ``enhax/train/checkpoints.py::save_checkpoint``
    writes, as numpy arrays: ``step``, ``epoch``, ``params``, ``opt_state``
    and, with EMA, ``ema``. ``optimizer_cfg`` is the run's optimizer config
    (the JAX package's dict, which the port's ``build_optimizer`` reads);
    ``trainer_cfg`` its ``accumulate_grad_batches``; ``model_cfg`` the
    model's arguments. Returns ``{"step", "epoch", "model", "optimizer",
    "ema"?, "grads"?}``, which ``train.checkpoints.load_checkpoint`` restores.

    The params and the EMA shadow go through ``jax_to_torch_state_dict``.
    optax's ``ScaleByAdamState`` maps into ``torch.optim.Adam``/``AdamW``'s
    state: ``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq`` (through the
    params' layout maps) and ``count`` -> ``step`` (both count the updates
    taken; the bias corrections then agree). The wrappers around it carry no
    state the port keeps elsewhere: ``clip_by_global_norm``, ``clip`` and
    ``add_decayed_weights`` none, the schedule's count is the port's update
    count (``state.step // accumulate_grad_batches``), and an
    ``inject_hyperparams`` learning rate (the plateau scheduler's) goes into
    the param groups. optax's ``MultiSteps`` holds the mean of the
    mini-batch gradients of an unfinished cycle (``acc_grads`` over
    ``mini_step`` mini-batches): it becomes their sum in ``grads``, which
    the port's step adds the next mini-batches to (``Trainer``'s
    accumulation sums into ``.grad`` and divides by k at the k-th)."""
    import copy

    from enhax_torch.models.base import build_model
    from enhax_torch.nn.optim import build_optimizer

    k = int((trainer_cfg or {}).get("accumulate_grad_batches") or 1)
    model = build_model(model_name, device="cpu", **(model_cfg or {}))
    model.module.load_state_dict(jax_to_torch_state_dict(model_name,
                                                         flatten_tree(payload["params"])))
    out = {"step": int(payload["step"]), "epoch": int(payload["epoch"]),
           "model": model.module.state_dict()}
    if payload.get("ema") is not None:
        ema = copy.deepcopy(model.module)
        ema.load_state_dict(jax_to_torch_state_dict(model_name, flatten_tree(payload["ema"])))
        out["ema"] = ema.state_dict()

    opt_state = payload["opt_state"]
    adam = _find(opt_state, ("count", "mu", "nu"))
    if len(adam) != 1:
        raise ValueError(f"{model_name}: expected one optax Adam state in the checkpoint's "
                         f"opt_state, found {len(adam)}: only adam/adamw map into the port")
    named = [(n, p) for n, p in model.module.named_parameters() if p.requires_grad]
    opt = build_optimizer(optimizer_cfg).init(named)
    mu = jax_to_torch_state_dict(model_name, flatten_tree(adam[0]["mu"]))
    nu = jax_to_torch_state_dict(model_name, flatten_tree(adam[0]["nu"]))
    count = float(np.asarray(adam[0]["count"]))
    for name, p in named:
        opt.state[p] = {"step": torch.tensor(count),
                        "exp_avg": mu[name].to(memory_format=torch.contiguous_format),
                        "exp_avg_sq": nu[name].to(memory_format=torch.contiguous_format)}
    for hp in _find(opt_state, ("hyperparams",)):
        if "learning_rate" in (_fields(hp["hyperparams"]) or {}):
            for group in opt.param_groups:
                group["lr"] = float(np.asarray(hp["hyperparams"]["learning_rate"]))
    out["optimizer"] = opt.state_dict()

    multi = _find(opt_state, ("mini_step", "gradient_step", "acc_grads"))
    if multi:
        mini = int(np.asarray(multi[0]["mini_step"]))
        if k <= 1 or mini != out["step"] % k:
            raise ValueError(f"the checkpoint's MultiSteps is at mini-batch {mini} of step "
                             f"{out['step']}; give trainer_cfg['accumulate_grad_batches'] "
                             "the run's k")
        if mini:
            acc = jax_to_torch_state_dict(model_name, flatten_tree(multi[0]["acc_grads"]))
            out["grads"] = {name: acc[name] * mini for name, _ in named}
    elif k > 1:
        raise ValueError(f"accumulate_grad_batches={k}, but the checkpoint's opt_state holds "
                         "no MultiSteps state")
    return out
