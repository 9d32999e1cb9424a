"""Hardened-scene accuracy matrix + local-BA observation-repair ablation.

Matrix: 3 seeds x {loop on, off} on the hardened VGA scene, with fixed
thresholds, plus the local-BA ablation rows — ba_every_kf=1 alone (the
documented harmful configuration) vs ba_every_kf=1 + post-correction
observation repair (`slam/keyframes.py::refresh_observations`, drop /
refresh modes): repair the DATA the window solver refits instead of
restraining the solver.

The accuracy numbers do not depend on the backend; fps columns from a
CPU run are host-bound and not throughput claims. Writes the full
result to the path given as the first argument (default
`eval_hardened.json`) and prints a one-line summary:

    python scripts/gen_eval.py [out.json]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

HARD = dict(
    clutter=6, depth_dropout=0.02, depth_quant=0.001,
    exposure_drift=0.15, yaw_sweep=0.35,
)
W, H = 640, 480
SCALE = W / 320.0


def main():
    from ra_slam_tpu.eval.trajectory_bench import run_trajectory_eval

    t0 = time.monotonic()
    rows = []

    def run(tag, **kw):
        t = time.monotonic()
        r = run_trajectory_eval(
            n_frames=150, width=W, height=H, scene_kw=HARD, **kw
        )
        r["config"] = tag
        rows.append(r)
        print(
            f"[{time.monotonic()-t0:6.0f}s] {tag} seed={kw.get('seed')} "
            f"loop={kw.get('loop_closure', True)}: ate {r['ate_rmse_m']} "
            f"lost {r['lost_frames']} closures {r['loop_closures']} "
            f"({time.monotonic()-t:.0f}s)", flush=True,
        )
        return r

    # hardened matrix
    for seed in (0, 1, 2):
        for loop in (True, False):
            run("baseline", seed=seed, loop_closure=loop)

    # local-BA ablation (loop on; reassoc gate is angular: 8 px @320).
    # One seed: the QVGA sweep already measured the same ordering at
    # three gates (see slam/system.py ba_every_kf comment).
    for seed in (0,):
        run("ba1", seed=seed, ba_every_kf=1)
        run("ba1+drop", seed=seed, ba_every_kf=1,
            reassoc_mode=1, reassoc_gate=8.0 * SCALE)
        run("ba1+refresh", seed=seed, ba_every_kf=1,
            reassoc_mode=2, reassoc_gate=8.0 * SCALE)

    base = [r for r in rows if r["config"] == "baseline" and r["loop_closure"]]
    accept = (
        all(r["lost_frames"] == 0 and r["loop_closures"] >= 1 for r in base)
        and all(
            r["ate_rmse_m"] < nl["ate_rmse_m"]
            for r, nl in zip(
                base,
                [x for x in rows
                 if x["config"] == "baseline" and not x["loop_closure"]],
            )
        )
    )
    out = {
        "description": (
            "North-star trajectory eval at 640x480 on the HARDENED "
            "synthetic scene (6 clutter boxes, 2% depth dropout, "
            "disparity-style depth quantization q=0.001, +-15% exposure "
            "drift, 0.35 rad yaw sweep, 0.5% depth noise), 3 seeds x "
            "{loop on, off} with fixed thresholds, PLUS the local-BA "
            "observation-repair ablation (ba_every_kf=1 alone vs + "
            "post-correction row drop/refresh, "
            "slam/keyframes.py::refresh_observations). Backend: "
            + jax.default_backend() + "; fps columns from a CPU run are "
            "host-bound, not throughput claims."
        ),
        "acceptance_pass": bool(accept),
        "rows": rows,
    }
    with open(sys.argv[1] if len(sys.argv) > 1 else "eval_hardened.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"acceptance_pass": accept, "n_rows": len(rows)}))


if __name__ == "__main__":
    main()
