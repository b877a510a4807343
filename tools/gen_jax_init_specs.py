"""Write ``enhax_torch/convert/jax_init_specs.json``: for each model of the
quality chains, every flax param's scope path, its count among its scope's
params, its initializer and shape, so that the PyTorch port draws the JAX
package's ``model.init(PRNGKey(0), ...)`` without JAX
(``enhax_torch.convert.jax_init``).

    python tools/gen_jax_init_specs.py [--check]

Runs where JAX is installed. Each param's initializer and count are found by
drawing candidates with the port's numpy generator and keeping the one that
reproduces JAX's own init (zeros and ones need no key; a uniform's bound is
taken from the formulas the models use, else fitted); every drawn value is
then held to JAX's within 4 float32 ulps of max|value|, or the tool fails.
``--check`` only verifies the committed file.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def chains() -> dict:
    """chain name -> (model, model_cfg, example shape), as run/make_quality.py
    inits them: the trainer on the (mosaic) training batch, the Predictor
    on one golden image."""
    from enhax_torch import quality as q
    out = {}
    for name, model, cfg, supervised, _, _ in q.MODELS_UNDER_TEST:
        div = 128 if model.startswith("uformer") else 64
        out[name] = (model, cfg, list(q.training_batch(supervised, div)["image"].shape))
    for name, spec in q.EXTRA_CHAINS:
        if not spec.get("_reuse_ckpt"):
            out[name] = (spec["model"], spec["model_cfg"], [1, 64, 64, 3])
    return out


def _close(a, b) -> bool:
    scale = max(float(np.abs(b).max()), 1e-30)
    return a.shape == b.shape and float(np.abs(a - b).max()) <= 4 * np.finfo(np.float32).eps * scale


def _candidates(shape, value):
    fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
    yield "zeros", []
    yield "ones", []
    yield "lecun_normal", []
    yield "normal", [0.02]
    bounds = [1.0 / fan_in] + [math.sqrt(6.0 / fan_in) / w for w in (30.0, 1.0)]
    for b in bounds:
        yield "uniform", [-b, b]


def find(path, value, count_max):
    """(count, init name, args) that reproduce ``value``."""
    from enhax_torch.convert import jax_init as ji
    root = ji.prng_key(0)
    shape = tuple(value.shape)
    for count in range(1, count_max + 1):
        key = ji.flax_param_key(root, tuple(path[:-1]), count)
        for name, args in _candidates(shape, value):
            if _close(ji.INITS[name](*args)(key, shape), value):
                return count, name, args
        # a uniform of another bound: fitted, then held as the others
        u = ji.uniform(key, shape, 0.0, 1.0).astype(np.float64) * 2 - 1
        if np.abs(u).sum() > 0:
            b = float((value * u).sum() / (u * u).sum())
            if b > 0 and _close(ji.uniform(key, shape, -b, b), value):
                return count, "uniform", [-b, b]
    raise RuntimeError(f"no initializer reproduces {'/'.join(path)} {shape}")


def spec_of(model, cfg, shape) -> list:
    import jax
    import jax.numpy as jnp
    from enhax.models.base import build_model
    jm = build_model(model, **cfg)
    v = jm.init(jax.random.PRNGKey(0), {"image": jnp.zeros(shape, jnp.float32)})
    leaves = [(tuple(str(getattr(k, "key", k)) for k in kp), np.asarray(a, np.float32))
              for kp, a in jax.tree_util.tree_flatten_with_path(v)[0]]
    per_scope = {}
    for path, _ in leaves:
        per_scope[path[1:-1]] = per_scope.get(path[1:-1], 0) + 1
    rows = []
    for path, value in leaves:
        assert path[0] == "params", path
        count, name, args = find(path[1:], value, per_scope[path[1:-1]])
        rows.append([list(path[1:]), count, name, args, list(value.shape)])
    return rows, {"params/" + "/".join(p[1:]): a for p, a in leaves}


def main(argv=None) -> None:
    p = argparse.ArgumentParser("gen-jax-init-specs")
    p.add_argument("--check", action="store_true")
    a = p.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from enhax_torch.convert import jax_init as ji
    specs = json.loads(ji.SPECS.read_text()) if a.check else {}
    for name, (model, cfg, shape) in chains().items():
        rows, ref = spec_of(model, cfg, shape)
        if not a.check:
            specs[name] = {"model": model, "model_cfg": cfg, "example": shape, "params": rows}
        drawn = ji.draw(specs[name]["params"])
        bad = [k for k in ref if not _close(drawn[k], ref[k])]
        if bad or set(drawn) != set(ref):
            raise SystemExit(f"{name}: drawn params differ from JAX's: {bad[:5]}")
        print(f"[gen_jax_init_specs] {name}: {model} {len(rows)} params match JAX's init")
    if not a.check:
        ji.SPECS.write_text(json.dumps(specs, separators=(",", ":")) + "\n")
        print(f"[gen_jax_init_specs] -> {ji.SPECS}")


if __name__ == "__main__":
    main()
