"""Helpers of the low-light and retouch families' parity tests: the JAX
package against the port on the CPU, one set of weights shared through the
bridge (``torch_instance_parity.pair``).

``check_forward_loss_grads`` holds the training forward, the loss and the
gradient of every parameter to the JAX package's: forward and loss within
1e-5 x max(1, max|ref|) (``TOL``) in float32, or, where both packages'
float32 part from float64 further (a narrow HVI-CIDNet on random weights:
the JAX package's own float32 output is 5e-5 from its float64), within 4x
the JAX package's float32 gap of its float64 (``assert_witnessed``); each
gradient within 1e-4 x max|ref| of its tensor (``TOL_GRAD``), by default in
float64 in both packages (where the float64 run still rounds, in the SSIM
terms both packages compute in float32, within 4x the JAX package's own
float32 gradient's gap from it).
``check_round_trip`` loads the port's state dict, under the
reference's torch names, into the JAX package's variables with its own
loader (``convert_state_dict`` and ``enhax/convert/mappings.py``'s map,
strict) and asks for the same variables back. ``run_both_clis`` trains a
shipped config (a tiny ``model_cfg``) through both packages' train CLIs on
a fabricated tree, the port from the JAX trainer's init, and returns both
logs and both final states; ``write_config`` writes a config for a model
that ships none.
"""

from __future__ import annotations

import contextlib
import csv
import re

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import torch

from enhax.convert.torch_weights import convert_state_dict
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.models import base as torch_base
from torch_instance_parity import (FACTOR, TOL, assert_close, assert_witnessed, flat_params,
                                   rel_err, to_torch)

TOL_GRAD = 1e-4


def _as(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


class _Float64Einsum:
    """``jax.numpy`` whose ``einsum`` drops ``preferred_element_type``."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(*args, preferred_element_type=None, **kwargs):
        return jnp.einsum(*args, **kwargs)


@contextlib.contextmanager
def float64_logits():
    """The attention logits of the JAX package's HVI-CIDNet and LYT-Net in
    the witness's float64: their einsums ask for float32 output, which
    would round the float64 witness's logits (the port keeps float64
    there)."""
    from enhax.models.llie import hvi_cidnet, lyt_net
    mods = (hvi_cidnet, lyt_net)
    saved = [m.jnp for m in mods]
    for m in mods:
        m.jnp = _Float64Einsum()
    try:
        yield
    finally:
        for m, j in zip(mods, saved):
            m.jnp = j


def check_forward_loss_grads(jm, v, tm, dp: dict, x64: bool = True,
                             out_keys: tuple | None = None, grads32: bool = True) -> dict:
    """The port's ``forward_loss`` and its gradients against the JAX
    package's: the float32 forward and loss against the JAX package's
    float32 at ``TOL`` (with ``x64``, where they part further, against the
    JAX package's float64 within 4x its own float32 gap from it,
    ``assert_witnessed``); the gradients at ``TOL_GRAD``, with ``x64``
    (where float32 sums part over a deep net's backward) both packages in
    float64, else in float32; in float64 within 4x the JAX package's own
    float32 gradient's gap where that is larger (the SSIM terms compute in
    float32 in both packages). With ``x64`` and ``grads32=False`` the JAX
    package's float32 gradients are not taken (a deep model's gradient
    compiles for seconds; no gap then widens the bound). Returns the errors
    by key."""
    name = tm.name
    vg = jax.jit(jax.value_and_grad(lambda w, d: jm.forward_loss(w, d), has_aux=True))
    if grads32 or not x64:
        (ref_loss, ref), grads = vg(v, dp)
        grads32 = jax_to_torch_state_dict(name, flat_params(grads))
    else:
        ref_loss, ref = jax.jit(lambda w, d: jm.forward_loss(w, d))(v, dp)
        grads32 = None
    if x64:
        with jax.enable_x64(True), float64_logits():
            witness = vg(_as(v, jnp.float64), _as(dp, jnp.float64))
            (loss64, ref64), grads = jax.tree_util.tree_map(
                lambda a: None if a is None else np.asarray(a, np.float64), witness)
    ref = {k: r for k, r in ref.items() if r is not None}
    with torch.no_grad():
        loss, out = tm.forward_loss(to_torch(dp))
    assert {k for k, o in out.items() if o is not None} == set(ref)
    errs = {}
    for k in ["loss"] + list(out_keys or sorted(ref)):
        o, r = (loss, ref_loss) if k == "loss" else (out[k], ref[k])
        if x64 and rel_err(o, r) > TOL:
            # float32 parts from float64 in both packages: the port within
            # 4x the JAX package's own float32 gap of the float64 witness
            errs[k] = assert_witnessed(o, r, loss64 if k == "loss" else ref64[k], key=k)
        else:
            errs[k] = assert_close(o, r)
    if x64:
        tm = tm.to(dtype=torch.float64)
    try:
        tm.module.zero_grad(set_to_none=True)
        inputs = {k: torch.from_numpy(np.asarray(a, np.float64 if x64 else np.float32))
                  for k, a in dp.items()}
        loss, _ = tm.forward_loss(inputs)
        loss.backward()
        ref_grads = jax_to_torch_state_dict(name, flat_params(grads))
        # a gradient that is zero but for rounding (a bias before an instance
        # norm, an attention key's bias) is measured against 1e-5 of the largest
        floor = 1e-5 * max(float(t.abs().max()) for t in ref_grads.values()
                           if t.is_floating_point())
        for n, p in tm.module.named_parameters():
            # a parameter the loss does not reach (HVI-CIDNet's i_lca5, whose
            # output the forward overwrites) has JAX's zero gradient
            g = (p.grad if p.grad is not None else torch.zeros_like(p)).double().numpy()
            r = ref_grads[n].double().numpy()
            scale = max(float(np.abs(r).max()), floor)
            err = float(np.abs(g - r).max()) / scale
            # the float64 witness still rounds where both packages compute in
            # float32 whatever the input (SSIM's and MS-SSIM's maps): the port
            # within 4x the JAX package's own float32 gap where that is larger
            gap = (float(np.abs(grads32[n].double().numpy() - r).max()) / scale
                   if x64 and grads32 is not None else 0.0)
            assert err <= max(TOL_GRAD, FACTOR * gap), (n, err, gap, float(np.abs(r).max()))
            errs[f"grad:{n}"] = (err, gap)
    finally:
        tm.to(dtype=torch.float32)
    return errs


def check_round_trip(tm, v, name_map: dict, drop=lambda key: False) -> None:
    """The port's state dict (the reference's names) -> the JAX package's
    variables by its own loader, strictly: every leaf matched, each equal."""
    sd = {k: t for k, t in tm.module.state_dict().items() if not drop(k)}
    back, report = convert_state_dict(sd, jax.tree_util.tree_map(np.zeros_like, v),
                                      name_map=name_map, strict=True)
    assert report == [], report
    want, got = flat_params(v), flat_params(back)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def write_image(path, img: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), cv2.cvtColor((img * 255).round().astype(np.uint8),
                                        cv2.COLOR_RGB2BGR))


def fabricate(root, dirs: dict, n: int = 2, hw: int = 32, seed: int = 0) -> None:
    """``root/<dir>/NAME.png`` for each dir in ``dirs`` ({dir: (lo, hi)}),
    n images of hw x hw, the same names in every dir."""
    rng = np.random.default_rng(seed)
    for d, (lo, hi) in dirs.items():
        for i in range(n):
            write_image(root / d / f"im{i}.png", rng.uniform(lo, hi, (hw, hw, 3)))


def tiny_config(src: str, dst, model_cfg: dict, image_size: int = 32,
                data_cfg: dict | None = None, **top) -> None:
    """A copy of config ``src`` with ``model_cfg`` merged in, the given
    image size, data config and top-level names, and no validation batches
    (``limit_val_batches`` 0: the test holds the training)."""
    ns: dict = {}
    exec(open(src).read(), ns)
    cfg = {k: v for k, v in ns.items() if not k.startswith("__")}
    cfg["model_cfg"] = {**cfg.get("model_cfg", {}), **model_cfg}
    cfg["image_size"] = image_size
    cfg["trainer_cfg"] = {**cfg.get("trainer_cfg", {}), "limit_val_batches": 0}
    if data_cfg is not None:
        cfg["data_cfg"] = {**cfg.get("data_cfg", {}), **data_cfg}
    cfg.update(top)
    dst.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))


def write_config(dst, model: str, model_cfg: dict, data: str, image_size: int = 32,
                 batch_size: int = 2, trainer_cfg: dict | None = None, seed: int = 0) -> None:
    """A train config of the train CLIs for a model with no shipped one:
    Adam at 2e-4 with no schedule, ``data``'s pairs at ``image_size`` in
    batches of ``batch_size``, no validation batches."""
    cfg = {"model": model, "model_cfg": model_cfg, "data": data,
           "data_cfg": {"batch_size": batch_size, "shuffle": True, "drop_last": True},
           "image_size": image_size,
           "optimizer_cfg": {"optimizer": {"name": "adam", "lr": 2e-4, "betas": (0.9, 0.999)}},
           "trainer_cfg": {"limit_val_batches": 0, **(trainer_cfg or {})},
           "seed": seed}
    dst.write_text("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))


def _log(path) -> list:
    with open(path) as f:
        return list(csv.DictReader(f))


def _float64_floats(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _uncast_ssim(components, mean, relu):
    """The packages' ``ssim`` without its cast to float32."""
    def ssim(input, target, data_range=1.0, window_size=11, sigma=1.5, k=(0.01, 0.03),
             non_negative=False):
        ssim_map, _ = components(input, target, data_range, window_size, sigma, k)
        return mean(relu(ssim_map) if non_negative else ssim_map)
    return ssim


def run_both_clis(config, root, tmp_path, monkeypatch, example: dict, steps: int = 2,
                  x64: bool = False, variables=None) -> tuple:
    """Both train CLIs over ``config`` on ``root`` for ``steps`` steps on the
    CPU; the port from the JAX trainer's init (the JAX model's ``init`` with
    the trainer's seed on ``example``, a batch of the first batch's shapes).
    With ``x64`` both train in float64 from that float32 init: the JAX
    package with x64 enabled, the init cast to float64 and its attention
    logits kept float64 (``float64_logits``), the port's weights cast after
    the load; in both the batches cast at the loss and SSIM without its cast
    to float32. Returns ((jax log rows, jax flat params), (port log
    rows, port state dict), model name). The JAX trainer starts from that
    jitted init, not its own eager one, or from ``variables`` where given (a
    deep model's jitted init compiles for longer than its train step)."""
    from enhax.cli import train as jax_cli
    from enhax.config.defaults import DEFAULT_TRAINER
    from enhax.models.base import build_model as jax_build_model
    from enhax.train import trainer as jax_trainer
    from enhax_torch.cli import train as port_cli

    argv = ["--config", str(config), "--root", str(root), "--steps", str(steps)]
    jargs = jax_cli.parse_train_args(argv + ["--save-dir", str(tmp_path / "jax")])
    name = jargs["model"]
    model_cfg = dict(jargs.get("model_cfg") or {})
    seed = {**DEFAULT_TRAINER, **(jargs.get("trainer_cfg") or {})}["seed"]
    init = variables if variables is not None else jax.jit(
        jax_build_model(name, **model_cfg).init)(
            jax.random.PRNGKey(seed), {k: jnp.asarray(a) for k, a in example.items()})
    init_sd = jax_to_torch_state_dict(name, flat_params(init))
    init_state = jax_trainer.Trainer.init_state
    start = _float64_floats(init) if x64 else init

    def init_state_from_jitted(self, example_batch, params=None):
        # the jitted init's values, which the trainer's own eager init draws
        # too (the same key), in a fraction of the time; placed as the step
        # places its outputs (replicated over the trainer's mesh), so that
        # the second step does not compile the step again
        # (on copies: the step donates its state, and ``variables`` may be
        # shared with other tests)
        from enhax.parallel.mesh import replicated
        assert params is None
        params = jax.tree_util.tree_map(jnp.array, start)
        return jax.device_put(init_state(self, example_batch, params), replicated(self.mesh))

    monkeypatch.setattr(jax_trainer.Trainer, "init_state", init_state_from_jitted)
    with contextlib.ExitStack() as x64_context:
        if x64:
            make_train_step = jax_trainer.make_train_step

            def make_train_step_float64(*args, **kwargs):
                # the batch too: a term of the target alone (its HVI, its
                # edge pyramid) would stay float32
                step = make_train_step(*args, **kwargs)
                return lambda state, batch, rng: step(state, _float64_floats(batch), rng)

            monkeypatch.setattr(jax_trainer, "make_train_step", make_train_step_float64)
            # the global flag, not the thread-local context: the CLI inits
            # and steps on threads of its own
            x64_context.callback(jax.config.update, "jax_enable_x64", jax.config.jax_enable_x64)
            jax.config.update("jax_enable_x64", True)
            x64_context.enter_context(float64_logits())
            # SSIM casts to float32 in both packages, whose rounding would
            # pick the sign of Adam's first step where a gradient is near 0
            from enhax.nn import metrics as jax_metrics
            from enhax_torch.nn import losses as port_losses
            from enhax_torch.nn import metrics as port_metrics
            monkeypatch.setattr(jax_metrics, "ssim", _uncast_ssim(
                jax_metrics._ssim_components, jnp.mean, jax.nn.relu))
            monkeypatch.setattr(port_losses, "ssim", _uncast_ssim(
                port_metrics._ssim_components, torch.mean, torch.relu))
        jstate = jax_cli.train(jargs)
    jflat = flat_params(jstate.params)

    if x64:
        forward_loss = torch_base.Model.forward_loss

        def forward_loss_float64(self, datapoint, **kwargs):
            return forward_loss(self, {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
                                       else v for k, v in datapoint.items()}, **kwargs)

        monkeypatch.setattr(torch_base.Model, "forward_loss", forward_loss_float64)
    build = torch_base.build_model

    def from_jax_init(*args, **kwargs):
        m = build(*args, **kwargs)
        m.module.load_state_dict(init_sd, strict=True)
        return m.to(dtype=torch.float64) if x64 else m

    monkeypatch.setattr(torch_base, "build_model", from_jax_init)
    state = port_cli.main(argv + ["--save-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert state.step == steps
    return ((_log(tmp_path / "jax" / "log.csv"), jflat),
            (_log(tmp_path / "port" / "log.csv"), state.module.state_dict()), name)


def assert_clis_agree(jax_run, port_run, name: str, tol: float = TOL,
                      reach: tuple | None = None) -> float:
    """Every logged train loss, and every parameter, within tol x max(1,
    max|ref|). ``reach=(pattern, bound)``: parameters whose names match
    ``pattern`` have a gradient that is zero but for rounding (a bias just
    before an instance norm), so Adam steps them by +-lr on the rounding's
    sign; they are held within ``bound`` (steps x 2 lr) on max|Δ|. Returns
    the largest parameter error."""
    (jlog, jflat), (plog, psd) = jax_run, port_run
    assert len(jlog) == len(plog) >= 1
    logged = 0
    for jr, pr in zip(jlog, plog):
        # a row whose epoch ended at max_steps holds no train loss, in both
        assert bool(jr.get("train/loss")) == bool(pr.get("train/loss"))
        if jr.get("train/loss"):
            assert_close(np.float64(pr["train/loss"]), np.float64(jr["train/loss"]), tol)
            logged += 1
    assert logged >= 1
    ref = jax_to_torch_state_dict(name, jflat)
    assert set(ref) == set(psd)
    worst = 0.0
    for k, r in ref.items():
        if not r.is_floating_point():
            continue
        if reach and re.fullmatch(reach[0], k):
            assert float((psd[k].float() - r).abs().max()) <= reach[1], k
        else:
            worst = max(worst, rel_err(psd[k].float(), r.numpy()))
    assert worst <= tol, worst
    return worst
