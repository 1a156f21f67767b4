#!/usr/bin/env python
"""Run every example input end-to-end with tiny overrides (CI smoke;
counterpart of ``/root/reference/tools/run_examples.sh``).

Usage: python tools/run_examples.py [--cpu]
"""

import copy
import glob
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    if "--cpu" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import numpy as np

    from pauxy_jax.qmc.calc import get_driver

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    inputs = sorted(glob.glob(os.path.join(root, "examples", "*", "input.json")))
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        for path in inputs:
            name = os.path.basename(os.path.dirname(path))
            opts = copy.deepcopy(json.load(open(path)))
            model = opts.get("model", opts.get("system", {}))
            if model.get("name", "Generic") == "Generic" and not os.path.exists(
                str(model.get("integrals", ""))
            ):
                # Bootstrap a small molecular integrals file in-repo
                # (utils/sgto.py) instead of skipping: H4 chain, the same
                # pipeline the H10 example uses. A bootstrap failure is a
                # single-example FAIL, not an abort of the whole smoke run.
                try:
                    from pauxy_jax.utils.sgto import dump_afqmc

                    dump_afqmc(4, 1.6, prefix=".")
                except Exception as e:  # noqa: BLE001 — CI smoke reporter
                    failures.append(name)
                    print(f"FAIL {name} (integral bootstrap): "
                          f"{type(e).__name__}: {str(e)[:160]}")
                    continue
                model["integrals"] = "afqmc.h5"
                model.setdefault("nup", 2)
                model.setdefault("ndown", 2)
                if "trial" in opts and "filename" not in opts["trial"]:
                    opts["trial"]["filename"] = "wfn.h5"
                print(f"# {name}: generated H4 integrals via utils/sgto")
            qmc = opts["qmc"]
            for k in ("blocks", "nblocks"):
                if k in qmc:
                    qmc[k] = 2
            qmc["nwalkers"] = min(int(qmc.get("nwalkers", 8)), 8)
            for k in ("num_steps", "nsteps"):
                if k in qmc:
                    qmc[k] = min(int(qmc[k]), 4)
            if "beta" in qmc:
                qmc["beta"] = min(float(qmc["beta"]), 0.25)
            opts.setdefault("estimates", {})["filename"] = f"{name}.h5"
            try:
                af = get_driver(opts)
                rows = np.asarray(af.run())
                assert np.isfinite(rows.real).all()
                print(f"OK {name}")
            except Exception as e:  # noqa: BLE001 — CI smoke reporter
                failures.append(name)
                print(f"FAIL {name}: {type(e).__name__}: {str(e)[:160]}")
    if failures:
        sys.exit(f"example failures: {failures}")
    print("ALL EXAMPLES OK")


if __name__ == "__main__":
    main()
