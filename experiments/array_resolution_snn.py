"""SNN beam patterns — twin of paper_plots/array_resolution_snn.py (complex
re-fold of the 2M-real beamforming vectors, :156-160), plus the linear-array
(array_resolution_linear_snn.py, jittered templates :173-181) and random-array
(array_resolution_random_snn.py) variants selected by --geometry."""
import json
import sys

import numpy as np

from common import FS, beam_pattern, beamwidth_3db, jittered_sinusoid_template

from haghighatshoarmuir2024 import (
    CenterCircularArray,
    LinearArray,
    Random2DArray,
)
from haghighatshoarmuir2024.models.snn_beamformer import SNNBeamformer


def build_geometry(kind: str):
    if kind == "circular":
        return CenterCircularArray(radius=4.5e-2, num_mic=7), np.linspace(-np.pi, np.pi, 16 * 7)
    if kind == "linear":
        # 7-mic ULA spanning 9 cm, half-plane grid (array_resolution_linear_snn.py)
        return (
            LinearArray(spacing=9e-2 / 6, num_mic=7, radius=None),
            np.linspace(-np.pi / 2, np.pi / 2, 16 * 7),
        )
    if kind == "random":
        return (
            Random2DArray(radius=4.5e-2, num_mic=13, seed=0),
            np.linspace(-np.pi, np.pi, 16 * 7),
        )
    raise ValueError(kind)


def main(kind: str = "circular", bipolar: bool = True):
    geometry, doa_list = build_geometry(kind)
    results = {}
    pats = {}
    for freq_design in (1_000.0, 2_000.0, 4_000.0):
        freq_range = (0.5 * freq_design, freq_design)
        freq_mid = float(np.mean(freq_range))
        tau = 1.0 / (2 * np.pi * freq_mid)
        snn = SNNBeamformer(
            geometry, 10e-3, freq_range, [tau, tau], bipolar_spikes=bipolar, fs=FS
        )
        t, sig = jittered_sinusoid_template(freq_mid, 0.25)
        bf_mat = snn.design_from_template((t, sig), doa_list)
        pattern = beam_pattern(bf_mat, complex_fold=bipolar)
        widths = [beamwidth_3db(pattern[i], doa_list) for i in range(len(doa_list))]
        results[f"{freq_design:.0f}Hz"] = {
            "beamwidth_3db_deg_mean": float(np.mean(widths)),
            "beamwidth_3db_deg_max": float(np.max(widths)),
        }
        pats[f"{freq_design:.0f} Hz"] = np.asarray(pattern[len(doa_list) // 2])
    from common import fig_polar_patterns

    fig_polar_patterns(pats, doa_list, f"array_resolution_snn_{kind}.pdf")
    print(
        json.dumps(
            {"experiment": f"array_resolution_snn_{kind}", "results": results}, indent=2
        )
    )
    return results


if __name__ == "__main__":
    kind = sys.argv[1] if len(sys.argv) > 1 else "circular"
    main(kind=kind)
