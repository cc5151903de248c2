"""MUSIC angular-response resolution — twin of
paper_plots/array_resolution_music.py (+ the linear-array
array_resolution_linear_music.py and random-array variants): angular power
spectrum via ``apply_to_template`` for sources at 0 and π/2, beamwidth and
peak-error metrics per design frequency."""
import json
import sys

import numpy as np
import jax

from common import FS, beamwidth_3db, sinusoid_template

from array_resolution_snn import build_geometry

from haghighatshoarmuir2024.models.music import MUSIC


def main(kind: str = "circular", snr_db: float = 20.0):
    geometry, doa_list = build_geometry(kind)
    results = {}
    pats = {}
    for freq_design in (1_000.0, 2_000.0, 4_000.0):
        freq_range = (0.5 * freq_design, freq_design)
        music = MUSIC(geometry, freq_range, doa_list, frame_duration=0.25, fs=FS)
        t, sig = sinusoid_template(0.75 * freq_design, 0.25)
        entry = {}
        for name, doa_target in (("doa_0", 0.0), ("doa_pi_2", np.pi / 2)):
            if kind == "linear" and doa_target > doa_list.max():
                continue
            aps = np.asarray(
                music.apply_to_template(
                    (t, sig, doa_target),
                    num_active_freq=1,
                    duration_overlap=0.0,
                    num_fft_bin=2048,
                    snr_db=snr_db,
                    key=jax.random.PRNGKey(0),
                )
            ).mean(0)
            est = doa_list[int(np.argmax(aps))]
            if name == "doa_0":
                pats[f"{freq_design:.0f} Hz"] = aps
            entry[name] = {
                "peak_err_deg": float(
                    np.rad2deg(np.arcsin(abs(np.sin(est - doa_target))))
                ),
                "beamwidth_3db_deg": beamwidth_3db(aps, doa_list),
            }
        results[f"{freq_design:.0f}Hz"] = entry
    from common import fig_polar_patterns

    # polar angular-response panels (paper_plots/array_resolution_music.py:95-180
    # figure style: MUSIC pseudo-spectrum per design frequency, source at 0)
    fig_polar_patterns(pats, doa_list, f"array_resolution_music_{kind}.pdf")
    print(
        json.dumps(
            {"experiment": f"array_resolution_music_{kind}", "results": results},
            indent=2,
        )
    )
    return results


if __name__ == "__main__":
    main(kind=sys.argv[1] if len(sys.argv) > 1 else "circular")
