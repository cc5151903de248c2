"""Post-processing of collected benchmark runs — twin of
paper_plots/analyse_array_localization.py: windowed median with jump
rejection, MAE against the per-band target medians the reference documents
(128.571429 / 129.375 / 132.589286 for its three bands, :67-81)."""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from haghighatshoarmuir2024.utils.stats import mae, window_median

REF_BANDS = {
    "demo-benchmark-simulation-freq1600-2000": 128.571429,
    "demo-benchmark-simulation-freq2000-2300": 129.375,
    "demo-benchmark-simulation-freq2300-2600": 132.589286,
}
REF_ROOT = "/root/reference/paper_plots"


def analyse_file(path: str, target: float, window_length: int = 25, reject_jump: float = 20.0):
    data = np.loadtxt(path)
    post = window_median(data, window_length, reject_jump)
    return {
        "mae_vs_target": round(mae(post, target), 6),
        "mae_vs_run_median": round(mae(post, float(np.median(data))), 6),
        "run_median": round(float(np.median(data)), 4),
    }


def main(extra_dirs=()):
    out = {}
    for band, target in REF_BANDS.items():
        d = os.path.join(REF_ROOT, band)
        if not os.path.isdir(d):
            continue
        out[band] = {
            f: analyse_file(os.path.join(d, f), target) for f in sorted(os.listdir(d))
        }
    for d in extra_dirs:
        if os.path.isdir(d):
            for f in sorted(os.listdir(d)):
                if f.endswith(".txt"):
                    data = np.loadtxt(os.path.join(d, f))
                    out.setdefault(os.path.basename(d), {})[f] = analyse_file(
                        os.path.join(d, f), float(np.median(data))
                    )
    print(json.dumps({"experiment": "analyse_array_localization", "results": out}, indent=2))
    return out


if __name__ == "__main__":
    main(extra_dirs=sys.argv[1:])
