"""Beam patterns of the Hilbert beamformer — twin of paper_plots/array_resolution.py.

Reference config: 7-mic CenterCircularArray r=4.5 cm, design frequencies
{1, 2, 3.6, 4, 8} kHz (paper_plots/array_resolution.py:119), sinusoid and
bandlimited-noise templates, beam pattern = |bf^H bf| plotted polar.
Prints the -3 dB beamwidth per design frequency instead of showing figures.
"""
import json

import numpy as np

from common import FS, bandlimited_noise_template, beam_pattern, beamwidth_3db, sinusoid_template

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.beamformer import Beamformer


def main(template_kind: str = "sin", num_grid: int = 16 * 7):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    doa_list = np.linspace(-np.pi, np.pi, num_grid)
    duration = 0.25
    kernel_duration = 10e-3

    results = {}
    pats = {}
    for freq_design in (1_000.0, 2_000.0, 3_600.0, 4_000.0, 8_000.0):
        freq_range = (0.5 * freq_design, freq_design)
        bf = Beamformer(geometry, kernel_duration, freq_range, fs=FS)
        if template_kind == "sin":
            t, sig = sinusoid_template(freq_design, duration)
        else:
            t, sig = bandlimited_noise_template(freq_range, duration)
        bf_mat, _ = bf.design_from_template((t, sig), doa_list)
        pattern = beam_pattern(bf_mat)
        widths = [beamwidth_3db(pattern[i], doa_list) for i in range(num_grid)]
        results[f"{freq_design:.0f}Hz"] = {
            "beamwidth_3db_deg_mean": float(np.mean(widths)),
            "beamwidth_3db_deg_max": float(np.max(widths)),
        }
        pats[f"{freq_design:.0f} Hz"] = np.asarray(pattern[num_grid // 2])
    from common import fig_polar_patterns

    fig_polar_patterns(pats, doa_list, f"array_resolution_{template_kind}.pdf")
    print(json.dumps({"experiment": f"array_resolution_{template_kind}", "results": results}, indent=2))
    return results


if __name__ == "__main__":
    import sys

    main(template_kind=sys.argv[1] if len(sys.argv) > 1 else "sin")
