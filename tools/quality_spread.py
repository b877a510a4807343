"""How far the quality chains of ``run/make_quality.py`` move with their
init, in the JAX package and in the port: each chain from the init of
several keys, and each of those times 1 + offset (a rounding-level change).

    python tools/quality_spread.py --package jax [--chains uformer_tiny,hinet_tiny_tiled]
        [--keys 0] [--offsets 0,1e-7,-1e-7]
    python tools/quality_spread.py --package torch --init jax|port [...]

``--package jax`` runs the JAX package's own chain (its trainer from
``model.init(PRNGKey(key), ...)``, its predict and metric CLIs; for an
instance chain its Predictor at ``seed=key``); it needs JAX. ``--package
torch`` runs the port's (``enhax_torch.quality``) on the CPU from the JAX
package's init of that key drawn in numpy (``--init jax``), or from the
port's own seeded init (``--init port``, ``build_model(seed=key)``).
A trained chain (``uformer_tiny``, ``hinet_tiny``, ...) prints its PSNR and
SSIM; ``hinet_tiny_tiled`` trains ``hinet_tiny`` and prints both rows and
the tiled chain's ``delta_vs_untiled``; an instance chain
(``colie_instance``, ``zero_mie_ms_instance``) prints the fitted row. One
line a run, ``[quality_spread] package init chain key offset: ...``.
``--losses 1,10,...`` adds a trained chain's training loss at those epochs,
to find where two trajectories part. ``--jobs N`` runs N chains at once, a
process each. Last, for each chain
and key, every metric's mean, sample standard deviation, min, max and mean
- 3 sd over the offsets: ``chip_smoke.py``'s ``phase_quality`` holds the two
bars that the JAX package's own chain does not keep at the JAX chain's mean
- 3 sd from key 0.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def jax_trained(name: str, key: int, scale: float, out: Path, history: list) -> Path:
    """The JAX package's trained chain ``name``; returns its checkpoint and
    appends the trainer's epoch rows to ``history``."""
    import jax
    import jax.numpy as jnp

    from enhax.models.base import build_model
    from enhax.train import Trainer
    from enhax_torch import quality as q

    _, model, cfg, supervised, epochs, lr = {r[0]: r for r in q.MODELS_UNDER_TEST}[name]
    jm = build_model(model, **cfg)
    batch = q.training_batch(supervised, jm.size_divisor)
    v = jax.jit(jm.init)(jax.random.PRNGKey(key), {k: jnp.asarray(a) for k, a in batch.items()})
    v = jax.tree_util.tree_map(lambda a: a * scale, v)
    tr = Trainer(jm, {"optimizer": {"name": "adam", "lr": lr},
                      "grad_clip_norm": 0.1 if not supervised else None},
                 max_epochs=epochs, seed=0, ckpt_dir=out / name / "ckpt",
                 log_every_n_steps=10**6)
    tr.fit(lambda: [batch], state=tr.init_state(batch, params=v), resume=False)
    history.extend(tr.history)
    return out / name / "ckpt" / "last"


def jax_scores(args: dict, out: Path, key: int = 0) -> dict:
    """The JAX predict and metric CLIs; the CLI's Predictor draws its init
    from ``PRNGKey(0)`` whatever ``--seed`` says, so ``key`` is handed to it
    here."""
    import functools

    import enhax.infer
    from enhax.cli.metric import measure_metric
    from enhax.cli.predict import predict
    from enhax_torch import quality as q
    cls = enhax.infer.Predictor
    enhax.infer.Predictor = functools.partial(cls, seed=key)
    try:
        pred = predict({**args, "data": str(q.GOLDEN / "image"), "save_dir": str(out)})
    finally:
        enhax.infer.Predictor = cls
    s = measure_metric({"input": str(pred), "target": str(q.GOLDEN / "ref"),
                        "metric": ["psnr", "ssim"]})
    return {"psnr": round(float(s["psnr"]), 3), "ssim": round(float(s["ssim"]), 4)}


def losses_at(history: list, epochs: tuple) -> dict:
    """The training loss of the given epochs (1-based), 7 significant digits."""
    return {e: float(f"{float(history[e - 1]['train/loss']):.7g}") for e in epochs
            if e <= len(history)}


def jax_chain(name: str, key: int, scale: float, out: Path, epochs: tuple = ()) -> dict:
    from enhax_torch import quality as q
    trained = {r[0]: r for r in q.MODELS_UNDER_TEST}
    extra = dict(q.EXTRA_CHAINS)
    if name in trained:
        _, model, cfg, *_ = trained[name]
        history = []
        ckpt = jax_trained(name, key, scale, out, history)
        row = jax_scores({"model": model, "model_cfg": cfg, "weights": str(ckpt), "seed": 0},
                         out / name / "pred")
        return {**row, "loss": losses_at(history, epochs)} if epochs else row
    spec = extra[name]
    args = {k: v for k, v in spec.items() if not k.startswith("_")}
    if spec.get("_reuse_ckpt"):
        base = spec["_reuse_ckpt"]
        row = {base: jax_chain(base, key, scale, out)}
        args["weights"] = str(out / base / "ckpt" / "last")
        row[name] = jax_scores(args, out / name / "pred")
        row["delta_vs_untiled"] = round(row[name]["psnr"] - row[base]["psnr"], 3)
        return row
    if scale != 1.0:
        raise SystemExit(f"{name}: an instance chain runs from the Predictor's own init; "
                         "give it --offsets 0")
    return jax_scores(args, out / name / "pred", key)


def torch_init(name: str, model: str, cfg: dict, init: str, key: int, scale: float) -> dict:
    import torch

    from enhax_torch.convert.jax_init import jax_init_state_dict
    from enhax_torch.models.base import build_model
    if init == "jax":
        sd = jax_init_state_dict(name, seed=key)
    else:
        sd = build_model(model, device="cpu", seed=key, **cfg).module.state_dict()
    return {k: v * scale if torch.is_floating_point(v) else v for k, v in sd.items()}


def torch_chain(name: str, init: str, key: int, scale: float, out: Path,
                epochs: tuple = ()) -> dict:
    import torch

    from enhax_torch import quality as q
    trained = {r[0]: r for r in q.MODELS_UNDER_TEST}
    extra = dict(q.EXTRA_CHAINS)
    keep = ("psnr", "ssim")
    if name in trained:
        _, model, cfg, sup, n, lr = trained[name]
        history = []
        row = q.run_one(name, model, cfg, sup, n, lr, out, "cpu",
                        init=torch_init(name, model, cfg, init, key, scale), history=history)
        row = {k: row[k] for k in keep}
        return {**row, "loss": losses_at(history, epochs)} if epochs else row
    spec = extra[name]
    if spec.get("_reuse_ckpt"):
        base = spec["_reuse_ckpt"]
        row = {base: torch_chain(base, init, key, scale, out)}
        row[name] = {k: v for k, v in q.run_chain(name, spec, out, "cpu").items() if k in keep}
        row["delta_vs_untiled"] = round(row[name]["psnr"] - row[base]["psnr"], 3)
        return row
    path = out / name / "init.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(torch_init(name, spec["model"], spec["model_cfg"], init, key, scale), path)
    row = q.run_chain(name, {**spec, "seed": key}, out, "cpu", weights=path)
    return {k: row[k] for k in keep}


def one_run(package: str, init: str, name: str, key: int, off: float, epochs: tuple) -> dict:
    """One chain from one init, in a temporary directory of its own."""
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        return (jax_chain(name, key, 1.0 + off, Path(tmp), epochs) if package == "jax"
                else torch_chain(name, init, key, 1.0 + off, Path(tmp), epochs))


def flat(row: dict, prefix: str = "") -> dict:
    """{"hinet_tiny": {"psnr": x}, "delta_vs_untiled": y} -> {"hinet_tiny.psnr": x, ...}."""
    out = {}
    for k, v in row.items():
        out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def summary(rows: list[dict]) -> dict:
    """Each metric's mean, sample standard deviation, min, max and mean - 3 sd
    over the runs of one chain and key."""
    import numpy as np
    out = {}
    for m in flat(rows[0]):
        v = np.array([flat(r)[m] for r in rows], np.float64)
        sd = float(v.std(ddof=1)) if len(v) > 1 else 0.0
        out[m] = {"n": len(v), "mean": round(float(v.mean()), 4), "sd": round(sd, 4),
                  "min": float(v.min()), "max": float(v.max()),
                  "mean_minus_3sd": round(float(v.mean()) - 3 * sd, 4)}
    return out


def summarize(logs: list) -> None:
    """The summary of the rows that earlier runs printed (one row a run and
    offset, the first of equal lines kept), by package, chain and key."""
    import ast
    import re
    line = re.compile(r"^\[quality_spread\] (.+) (\S+) key (\d+) init x \(1 (\S+)\): (\{.*\})$")
    rows = {}
    for log in logs:
        for text in Path(log).read_text().splitlines():
            m = line.match(text)
            if m:
                label, name, key, off, row = m.groups()
                rows.setdefault((label, name, int(key)), {}).setdefault(
                    float(off), ast.literal_eval(row))
    for (label, name, key), by_off in rows.items():
        print(f"[quality_spread] {label} {name} key {key} over {len(by_off)} offsets "
              f"({', '.join(f'{o:+g}' for o in sorted(by_off))}): "
              f"{summary(list(by_off.values()))}", flush=True)


def main(argv=None) -> None:
    import concurrent.futures
    import multiprocessing
    p = argparse.ArgumentParser("quality-spread")
    p.add_argument("--package", choices=("jax", "torch"), default="jax")
    p.add_argument("--init", choices=("jax", "port"), default="jax",
                   help="--package torch: the JAX package's init drawn in numpy, or the port's")
    p.add_argument("--chains", default="uformer_tiny,hinet_tiny_tiled")
    p.add_argument("--keys", default="0", help="comma-separated init keys (seeds)")
    p.add_argument("--offsets", default="0,1e-7,-1e-7",
                   help="the init is multiplied by 1 + each offset")
    p.add_argument("--jobs", type=int, default=1, help="runs at once, each in a process")
    p.add_argument("--losses", default="",
                   help="comma-separated epochs whose training loss a trained chain prints")
    p.add_argument("--summarize", nargs="+", metavar="LOG",
                   help="run nothing: the summary over the rows that earlier runs printed "
                        "to these logs, by package, chain and key")
    a = p.parse_args(argv)
    if a.summarize:
        return summarize(a.summarize)
    label = "jax" if a.package == "jax" else f"torch init={a.init}"
    runs = [(name, int(key), float(off)) for name in a.chains.split(",")
            for key in a.keys.split(",") for off in a.offsets.split(",")]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(a.jobs, mp_context=ctx) as pool:
        epochs = tuple(int(e) for e in a.losses.split(",") if e)
        futures = [pool.submit(one_run, a.package, a.init, *run, epochs) for run in runs]
        rows = {}
        for (name, key, off), fut in zip(runs, futures):
            rows.setdefault((name, key), []).append(fut.result())
            print(f"[quality_spread] {label} {name} key {key} init x (1 {off:+g}): "
                  f"{rows[name, key][-1]}", flush=True)
    for (name, key), rs in rows.items():
        print(f"[quality_spread] {label} {name} key {key} over {len(rs)} offsets: "
              f"{summary(rs)}", flush=True)


if __name__ == "__main__":
    main()
