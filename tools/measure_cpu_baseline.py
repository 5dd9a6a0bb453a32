"""Measured CPU wall-clock for the reference's metric path (BASELINE.md datum).

BASELINE.md's "0.5-2 s/pair" for the reference CPU pipeline was an estimate;
this tool replaces it with a measurement. It times the independent C++ oracle's
mode-4 full chain — pyramid build (pyrDown / valid-mean range / Jaimez
gradients / seam masks) + the float spherical GN loop, re-derived from
reference include/RegisterPhotoICP.h:292-398,4519-4784 — on the bundled pair
at the exact workload bench.py runs (1920x320, 5 levels, PHOTO_DEPTH,
reference iteration policy; the oracle reproduces the golden iteration
signature [0,7,10,10,10], tests/test_cpp_oracle.py).

Caveats the report carries:
  * The oracle is single-threaded; the reference parallelizes the per-pixel
    loops with OpenMP (RegisterPhotoICP.h:3122-3124). We report measured
    single-thread seconds plus an optimistic /8-thread bound (the rig has 8
    sensors; contemporary dev boxes were ~4-8 cores, and OpenMP reductions
    never scale perfectly, so true reference time lies between the two).
  * Built -O3 -march=native, matching the reference's -O3 -mtune=native
    (reference CMakeLists.txt:73-75); subprocess wall time includes reading
    the ~20 MB input stream (<5% of a multi-second run, measured by the
    reported spread).

Usage: python tools/measure_cpu_baseline.py [--repeat 5]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools import cpp_oracle  # noqa: E402

BIN_O3 = os.path.join(os.path.dirname(cpp_oracle.BIN), "photoicp_oracle_o3")
GOLDEN = os.path.join(
    os.path.dirname(__file__), "..", "tests", "golden", "pair_1_10.npz"
)


def build_o3() -> str:
    if not os.path.exists(BIN_O3) or os.path.getmtime(BIN_O3) < os.path.getmtime(
        cpp_oracle.SRC
    ):
        # EXACTLY the reference's optimization flags (-O3 -mtune=native,
        # reference CMakeLists.txt:73-75). NOT -march=native: that enables
        # FMA contraction, which perturbs the last-ulp-sensitive GN accept
        # cascade into a different (in-basin) stopping point — a different
        # iteration count would time a different workload than the golden.
        subprocess.run(
            ["g++", "-O3", "-mtune=native", "-std=c++14", "-o", BIN_O3,
             cpp_oracle.SRC],
            check=True, capture_output=True,
        )
    return BIN_O3


def _cpu_model() -> str:
    try:
        text = open("/proc/cpuinfo").read()
        for key in ("model name", "Hardware", "cpu model", "CPU part"):
            for line in text.splitlines():
                if line.startswith(key) and ":" in line:
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args()

    z = np.load(GOLDEN)
    h, w = z["gray_src_u8"].shape
    zeros = np.zeros((h, w), np.float32)
    level0 = dict(
        gray_src=z["gray_src_u8"].astype(np.float32) / np.float32(255.0),
        depth_src=z["depth_src_mm"].astype(np.float32) * np.float32(0.001),
        gray_trg=z["gray_trg_u8"].astype(np.float32) / np.float32(255.0),
        depth_trg=z["depth_trg_mm"].astype(np.float32) * np.float32(0.001),
        gray_trg_gx=zeros, gray_trg_gy=zeros,
        depth_trg_gx=zeros, depth_trg_gy=zeros,
    )
    stream = "/tmp/cpu_baseline_in.bin"
    cpp_oracle.pack(
        stream, [level0], np.eye(4, dtype=np.float32), mode=4, method=2,
        use_double=False, apply_seam_mask=True, n_levels=int(z["n_levels"]),
    )
    binary = build_o3()

    times = []
    r = None
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        r = cpp_oracle.run(stream, binary=binary)
        times.append(time.perf_counter() - t0)

    # sanity: the timed run must execute the GOLDEN workload — identical
    # per-level iteration counts (the iteration profile IS the work, PERF.md
    # "The honest landscape") and the golden free-run pose (same gates as
    # test_cpp_full_chain_from_raw_images_lands_on_golden_pose)
    iters = [lv["iters"] for lv in r["levels"]]
    assert iters == list(z["free_iters"]), (
        f"iteration signature {iters} != golden {list(z['free_iters'])} — "
        "this build times a different workload; check compiler flags"
    )
    t_err = float(np.linalg.norm(r["pose"][:3, 3] - z["free_pose"][:3, 3]))
    assert t_err < 2e-3, f"oracle pose diverged from golden ({t_err})"

    best, med = min(times), sorted(times)[len(times) // 2]
    ncores_ref = 8
    report = {
        "metric": "cpu_reference_align_s_per_pair",
        "single_thread_best_s": round(best, 3),
        "single_thread_median_s": round(med, 3),
        "optimistic_8thread_bound_s": round(best / ncores_ref, 3),
        "runs": [round(t, 3) for t in times],
        "host_cpu": _cpu_model(),
        "workload": "1920x320, 5 levels, PHOTO_DEPTH, full chain (pyramids + GN)",
        "pose_gate_t_err_m": round(t_err, 6),
    }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
