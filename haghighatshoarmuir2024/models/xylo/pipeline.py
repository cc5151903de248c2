"""Quantized SNN localization pipeline — the Demo equivalent
(micloc/xylo_snn_localization.py:74-542), torch/rockpool-free and jittable
end-to-end.

Construction: per frequency band an :class:`SNNBeamformer` is designed from a
sinusoid template at the band center (taus = 1/(2π f_mid), reference :115-145);
the per-band beamforming matrices become the block-diagonal input weights of a
2-layer SNN, quantized to Xylo-A2 integers; inference runs the integer LIF
simulator.

Inference chain (``spike_encoding → xylo_process → extract_rate →
estimate_doa_from_rate``) keeps the reference method names and contracts, and
additionally exposes :meth:`forward` — the whole chain as one jitted function
(audio frame in, DoA + rate out), which is the flagship benchmarked program.
"""
from __future__ import annotations

import functools
import numpy as np
import jax
import jax.numpy as jnp

from ...config import FS, on_accelerator
from ...geometry import ArrayGeometry
from ...ops.filterbank import ButterworthFilterbank
from ...ops.stht import stht
from ..snn_beamformer import SNNBeamformer
from .quantize import global_quantize, validate_config
from .sim import XyloSim
from .spec import build_localization_spec


def _blockcos(x, G: int):
    """Per-band cosine normalization for band-stacked matched scoring:
    mean-remove and unit-normalize each G-wide band block of the trailing
    axis.  A noise-dominated band then contributes a bounded cosine term to
    the summed score instead of a variance-dominating raw inner product —
    measured on the speech MC (experiments/multiband_speech.py): raw stacked
    correlation 25.6° @ -10 dB vs 12.6° with this normalization, and sub-1°
    at >= 8 dB where the folded profile gives 2-4°."""
    xb = x.reshape(x.shape[:-1] + (-1, G))
    xb = xb - xb.mean(axis=-1, keepdims=True)
    n = jnp.linalg.norm(xb, axis=-1, keepdims=True)
    return (xb / jnp.maximum(n, 1e-12)).reshape(x.shape)


def _cos1(x):
    """Mean-remove + unit-normalize the trailing axis (cosine coordinates).
    Invariant to positive-affine maps of x, which is what lets the folded
    profile be derived from the stacked calibration table (see
    :func:`_auto_blend_scores`)."""
    xc = x - x.mean(axis=-1, keepdims=True)
    return xc / jnp.maximum(jnp.linalg.norm(xc, axis=-1, keepdims=True), 1e-12)


def _auto_blend_scores(rate, prof_stacked, G: int, weight: str = "peak2"):
    """SNR-adaptive blend of the band-stacked matched scores (ROADMAP's
    "remaining estimator idea", measured in experiments/multiband_speech.py).

    Components, all bounded cosines in [-1, 1] against the same P grid rows:
    the F per-band cosine score vectors (each band's angular response matched
    in its own coordinates, the ``matched_stacked`` evidence — wins at
    moderate/high SNR) and the folded-profile cosine (the reference fold's 3x
    band-noise averaging — wins below ~-4 dB).  Each component is weighted by
    its own achieved confidence, so the blend adapts per trial with no SNR
    oracle:

      * ``weight="peak"``      w = max_p score   (amplitude weighting)
      * ``weight="peak2"``     w = (max_p score)^2  (power / MRC-style) —
        the default: best measured blend on the 3-band speech MC (100
        sims — 8.2° @ -10 dB vs 9.4° for the fixed cosine+folded sum
        and 10.3° for pure per-band cosine, equal to cosine within noise
        at >= 2 dB)
      * ``weight="contrast"``  w = max(peak - median_p score, 0) — a noise
        band's spurious peak rides on a high floor of correlated cosines
        across the grid, so contrast discounts it harder than raw peak.

    The folded component needs no second calibration: cos1 is invariant to
    positive-affine maps, and folding a calibrated stacked row (row-normalized
    raw rates) is affine in the folded raw rates, so
    ``cos1(fold(stacked row)) == cos1(fold(raw rates))`` exactly.

    rate: (..., H) unfolded rates, prof_stacked: (P, H), H = F*G."""
    F = rate.shape[-1] // G
    prec = jax.lax.Precision.HIGHEST
    cb = _blockcos(rate, G).reshape(rate.shape[:-1] + (F, G))
    pb = _blockcos(prof_stacked, G).reshape(prof_stacked.shape[0], F, G)
    Sb = jnp.einsum("...fg,pfg->...fp", cb, pb, precision=prec)
    rf = _cos1(rate.reshape(rate.shape[:-1] + (F, G)).mean(axis=-2))
    pf = _cos1(prof_stacked.reshape(prof_stacked.shape[0], F, G).mean(axis=-2))
    Sf = jnp.matmul(rf, pf.T, precision=prec)
    comp = jnp.concatenate([Sb, Sf[..., None, :]], axis=-2)  # (..., F+1, P)
    pk = comp.max(axis=-1)
    if weight == "peak":
        w = pk
    elif weight == "peak2":
        w = pk**2
    elif weight == "contrast":
        w = jnp.maximum(pk - jnp.median(comp, axis=-1), 0.0)
    else:
        raise ValueError(f"unknown auto-blend weight {weight!r}")
    return (comp * w[..., None]).sum(axis=-2)


@functools.partial(jax.jit, static_argnames=("bas", "time_major"))
def _encode_cumsum(sig_in, kernel, bas, time_major=False):
    """Audio frame (T, M) → integrated bandpassed analytic stack (C, T)
    (or (T, C) with ``time_major=True`` — the whole computation is naturally
    time-major, so this skips the final transpose for consumers in that
    layout, e.g. the batched RZCC and LIF).

    First half of ``Demo.spike_encoding`` (micloc/xylo_snn_localization.py:315-342).

    The RZCC encoder peaks the *cumsum* of the bandpassed signal.  On the
    CPU, cumsum ∘ IIR(b, a) == IIR(b, a ⊛ [1, −1]) folds the integration into
    the bandpass denominator, so each band is one sequential filter pass.  On
    the accelerator the stable bandpass and the integrator run as one lifted
    blocked pass (batched matmuls plus a 32x shorter scan), with the cumsum
    folded into the block form's output map and the marginal instability
    confined to an exactly carried running offset
    (``ops/iir._iir_cumsum_blocked``); the lifted matrices of the integrated
    filter itself would not survive float32.  Both forms agree up to float
    associativity (tests/test_ops_filters.py).
    """
    from ...ops.iir import iir_filter

    # the quadrature FIR as a padded FFT convolution on every backend (on
    # the GPU it beat blocked-Toeplitz matmuls in the flagship step)
    sig_h = stht(sig_in, kernel, axis=0, method="fft")
    sig_real = jnp.concatenate([sig_h.real, sig_h.imag], axis=1)  # (T, 2M)

    if on_accelerator():
        css = [
            iir_filter(np.asarray(b), np.asarray(a), sig_real, axis=0, method="blocked_cumsum")
            for b, a in bas
        ]
    else:
        css = [
            iir_filter(
                np.asarray(b),
                np.convolve(np.asarray(a), [1.0, -1.0]),
                sig_real,
                axis=0,
                method="scan",
            )
            for b, a in bas
        ]
    out = jnp.concatenate(css, axis=1)  # time-major (T, C)
    return out if time_major else out.T  # channel-major (C, T) by default


@functools.partial(jax.jit, static_argnames=("robust_width", "bipolar"))
def _spikes_from_cumsum(cs_all, robust_width, bipolar):
    """Integrated stack (..., C, T) → RZCC spike raster (..., T, C or 2C).

    Second half of ``Demo.spike_encoding``
    (micloc/xylo_snn_localization.py:344-355); batch-native over leading dims
    so the suppression's isolation fast path stays a true conditional (inside
    ``vmap`` it would execute both branches).
    """
    # bounded plateau search: exact for continuous signals, avoids full-length
    # cummax passes; one encoded boundary pass yields both polarities
    # (see ops/peaks.local_extrema_mask_bounded)
    from ...ops.peaks import local_extrema_mask_bounded, select_by_distance

    maxima, minima = local_extrema_mask_bounded(cs_all, 2 * robust_width)
    if bipolar:
        cand = jnp.concatenate([maxima, minima], axis=-2)
        heights = jnp.concatenate([cs_all, -cs_all], axis=-2)
        masks = select_by_distance(cand, heights, robust_width)
        C = cs_all.shape[-2]
        peaks, valleys = masks[..., :C, :], masks[..., C:, :]
        # reference overwrite semantics: −1 wins on collision
        pos = (peaks & ~valleys).astype(jnp.int32)
        neg = valleys.astype(jnp.int32)
        out = jnp.concatenate([pos, neg], axis=-2)  # (..., 2C, T)
        return jnp.swapaxes(out, -1, -2)  # (..., T, 2C)
    masks = select_by_distance(maxima, cs_all, robust_width)
    return jnp.swapaxes(masks, -1, -2).astype(jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("bas", "robust_width", "bipolar")
)
def _spike_encoding_core(sig_in, kernel, bas, robust_width, bipolar):
    """STHT → real-stack → filterbank → band-concat → RZCC → polarity split.

    Port of ``Demo.spike_encoding`` (micloc/xylo_snn_localization.py:315-356).
    Output: (T, 2·2M·F) int32 when bipolar else (T, 2M·F).
    """
    cs_all = _encode_cumsum(sig_in, kernel, bas=bas)
    return _spikes_from_cumsum(cs_all, robust_width=robust_width, bipolar=bipolar)


class Demo:
    """Quantized Xylo-style SNN localization (micloc/xylo_snn_localization.py:74-542).

    ``xylosim_version`` is kept for API parity; hardware deployment is out of
    scope here, so the integer simulator is always used, but the flag selects
    whether the hardware-only input-channel constraint is enforced.
    """

    def __init__(
        self,
        geometry: ArrayGeometry,
        freq_bands,
        doa_list,
        recording_duration: float = 0.25,
        kernel_duration: float = 10e-3,
        bipolar_spikes: bool = True,
        xylosim_version: bool = True,
        fs: float = FS,
        target_dt: float = 1e-3,
        design_chunk: int = 32,
        use_cache: bool = True,
        enforce_hw_limits: bool = True,
    ):
        self.geometry = geometry
        self.freq_bands = np.atleast_2d(np.asarray(freq_bands, dtype=np.float64))
        self.doa_list = np.asarray(doa_list, dtype=np.float64)
        self.recording_duration = recording_duration
        self.kernel_duration = kernel_duration
        self.bipolar_spikes = bool(bipolar_spikes)
        self.xylosim_version = bool(xylosim_version)
        # ``enforce_hw_limits=False`` waives the Xylo-A2 chip RESOURCE caps
        # (hidden-neuron count; the reference's own live benchmark runs ONE
        # band at a time because 3 bands x 449 grid exceeds the 1000-neuron
        # chip, snn_localization_benchmark.py:556-562) — the integer
        # simulator has no such limit, so larger-than-chip deployments run as
        # software.  Numeric quantization-range checks remain fatal.
        self.enforce_hw_limits = bool(enforce_hw_limits)
        self.fs = fs
        self.dt = 1.0 / fs

        # design checkpoint cache: the reference recomputes designs at every
        # process start (SURVEY §5); designs are pure functions of the config
        from ...utils.cache import (
            DesignCache,
            design_cache_key,
            enable_persistent_compilation_cache,
        )

        enable_persistent_compilation_cache()

        cache = DesignCache() if use_cache else None
        cache_key = design_cache_key(
            r_vec=geometry.r_vec,
            theta_vec=geometry.theta_vec,
            speed=geometry.speed,
            freq_bands=self.freq_bands,
            doa_list=self.doa_list,
            recording_duration=recording_duration,
            kernel_duration=kernel_duration,
            bipolar=bipolar_spikes,
            fs=fs,
            version=1,
        )
        cached = cache.load(cache_key) if cache else None

        # per-band beamformer design (micloc/xylo_snn_localization.py:115-145)
        self.beamfs = []
        self.bf_mats = []
        self.tau_vecs = []
        for freq_range in self.freq_bands:
            freq_mid = float(np.mean(freq_range))
            tau_mem = 1.0 / (2 * np.pi * freq_mid)
            tau_vec = [tau_mem, tau_mem]
            self.tau_vecs.append(tau_vec)
            beamf = SNNBeamformer(
                geometry=geometry,
                kernel_duration=kernel_duration,
                freq_range=freq_range,
                tau_vec=tau_vec,
                bipolar_spikes=bipolar_spikes,
                fs=fs,
                design_chunk=design_chunk,
            )
            self.beamfs.append(beamf)
            band_idx = len(self.bf_mats)
            if cached is not None and f"bf_{band_idx}" in cached:
                self.bf_mats.append(cached[f"bf_{band_idx}"])
            else:
                time_temp = np.arange(0, recording_duration, step=1 / fs)
                sig_temp = np.sin(2 * np.pi * freq_mid * time_temp)
                bf_vecs = beamf.design_from_template(
                    template=(time_temp, sig_temp), doa_list=self.doa_list
                )
                self.bf_mats.append(np.asarray(bf_vecs))
        self.tau_vecs = np.asarray(self.tau_vecs)
        # fail fast on a degenerate design — a NaN column here once cached
        # silently zeroed every later run of this config (the quantizer turns
        # NaN into INT_MIN weights and the SNN goes silent)
        for i, m in enumerate(self.bf_mats):
            if not np.all(np.isfinite(m)):
                raise FloatingPointError(
                    f"beamforming design for band {i} contains non-finite "
                    "values — refusing to use or cache it"
                )
        if cache is not None and cached is None:
            cache.save(
                cache_key,
                {f"bf_{i}": m for i, m in enumerate(self.bf_mats)},
            )

        # shared order-1 filterbank (micloc/xylo_snn_localization.py:149-153)
        self.filterbank = ButterworthFilterbank(
            freq_bands=self.freq_bands, order=1, fs=fs
        )
        self._bas = tuple(
            (tuple(b.tolist()), tuple(a.tolist())) for b, a in self.filterbank.ba_list
        )

        self._initialize_snn_module(target_dt=target_dt)

    # ---------------------------------------------------------------- SNN init
    def _initialize_snn_module(self, target_dt: float):
        """Spec assembly + quantization + simulator
        (micloc/xylo_snn_localization.py:173-313)."""
        self.spec = build_localization_spec(
            bf_mats=self.bf_mats,
            tau_vecs=[tuple(tv) for tv in self.tau_vecs],
            fs=self.fs,
            target_dt=target_dt,
            bipolar_spikes=self.bipolar_spikes,
            threshold=1.0,
        )
        self.xylo_config = global_quantize(self.spec)
        problems = validate_config(
            self.xylo_config,
            hardware=not self.xylosim_version,
            resource_limits=getattr(self, "enforce_hw_limits", True),
        )
        if problems:
            if self.xylosim_version:
                raise ValueError("invalid Xylo configuration: " + "; ".join(problems))
            # mirror the reference's automatic fallback to the simulator
            # (micloc/xylo_snn_localization.py:292-313)
            print(
                "Xylo hardware constraints violated; falling back to the "
                "software simulator: " + "; ".join(problems)
            )
            self.xylosim_version = True
        self.xylo = XyloSim.from_config(self.xylo_config, output_mode="Spike", dt=target_dt)

    # ------------------------------------------------------------ the pipeline
    def spike_encoding(self, sig_in) -> jnp.ndarray:
        """Audio frame (T, M) → input spike raster
        (micloc/xylo_snn_localization.py:315-356)."""
        sig_in = jnp.asarray(sig_in, dtype=jnp.float32)
        self._check_channels(sig_in)
        return _spike_encoding_core(
            sig_in,
            jnp.asarray(self.beamfs[0].kernel, dtype=jnp.float32),
            bas=self._bas,
            robust_width=self.beamfs[0].robust_width,
            bipolar=self.bipolar_spikes,
        )

    def xylo_process(self, spikes_in) -> jnp.ndarray:
        """Input spikes → hidden-layer spike raster
        (micloc/xylo_snn_localization.py:358-377)."""
        self.xylo.reset_state()
        out, state, rec = self.xylo(spikes_in, record=True)
        return rec["Spikes"]

    def extract_rate(self, spikes_in, fold: bool = True) -> jnp.ndarray:
        """Hidden raster → per-DoA spike rate, folded over frequency channels
        (micloc/xylo_snn_localization.py:379-398).  ``fold=False`` returns the
        unfolded (F·G,) per-band rates (what ``method="matched_stacked"``
        consumes)."""
        num_DoA_grid = len(self.doa_list)
        rate_channels = jnp.mean(jnp.asarray(spikes_in, jnp.float32), axis=0) * self.fs
        if not fold:
            return rate_channels
        return rate_channels.reshape(-1, num_DoA_grid).mean(0)

    def estimate_doa_from_rate(self, spike_rate, method: str = "peak"):
        """Rate profile → DoA (micloc/xylo_snn_localization.py:400-444), plus
        the bias-free ``"matched"`` estimator (requires
        :meth:`calibrate_profiles`) and its multi-band ``"matched_stacked"``
        variant, which takes the UNFOLDED rates from
        ``extract_rate(..., fold=False)`` (requires
        ``calibrate_profiles(band_stacked=True)``)."""
        method_list = [
            "peak", "periodic_ml", "trimmed_periodic_ml", "matched",
            "matched_stacked", "matched_auto",
        ]
        if method not in method_list:
            raise ValueError(
                f"only the following estimation methods are supported:\n{method_list}"
            )
        if method in ("matched", "matched_stacked", "matched_auto"):
            profiles = (
                getattr(self, "_profiles", None) if method == "matched"
                else getattr(self, "_profiles_stacked", None)
            )
            if profiles is None:
                raise ValueError(
                    "call calibrate_profiles() before method='matched' / "
                    "calibrate_profiles(band_stacked=True) before "
                    "method='matched_stacked' / 'matched_auto'"
                )
            r = jnp.asarray(spike_rate)
            if r.shape[-1] != profiles.shape[-1]:
                raise ValueError(
                    f"rate length {r.shape[-1]} does not match the profile "
                    f"table width {profiles.shape[-1]} — matched_stacked/"
                    "matched_auto take extract_rate(..., fold=False)"
                )
            G = len(self.doa_list)
            if method == "matched_auto":
                scores = _auto_blend_scores(r, jnp.asarray(profiles), G)
                return jnp.asarray(self.doa_list)[jnp.argmax(scores)]
            if method == "matched_stacked":
                r = _blockcos(r, G)
                profiles = _blockcos(jnp.asarray(profiles), G)
            else:
                r = r - jnp.mean(r)
            # f32-exact: a reduced-precision (TF32) matmul can flip near-tie
            # argmaxes
            scores = jnp.matmul(
                profiles, r, precision=jax.lax.Precision.HIGHEST
            )
            return jnp.asarray(self.doa_list)[jnp.argmax(scores)]
        spike_rate = jnp.asarray(spike_rate)
        doa_list = jnp.asarray(self.doa_list)
        if method == "peak":
            return doa_list[jnp.argmax(spike_rate)]
        if method == "periodic_ml":
            weighted_exp = jnp.mean(spike_rate * jnp.exp(1j * doa_list))
            return jnp.angle(weighted_exp)
        # trimmed_periodic_ml
        DoA_index = jnp.argmax(spike_rate)
        num_DoA = len(self.doa_list) // 2
        # Quirk reproduced: the reference writes ``np.arange(-num_DoA // 2, ...)``
        # (micloc/xylo_snn_localization.py:434) — Python floor division of the
        # negated value, so for odd num_DoA the window extends one step further
        # on the low side (length num_DoA+1, not num_DoA).
        DoA_range = (
            jnp.arange(-num_DoA // 2, num_DoA // 2 + 1) - DoA_index
        )
        weighted_exp = jnp.mean(
            spike_rate[DoA_range] * jnp.exp(1j * doa_list[DoA_range])
        )
        return jnp.angle(weighted_exp)

    # ------------------------------------------------------------ checkpointing
    def save(self, path: str):
        """Serialize the complete deployable model — geometry, designed
        beamforming matrices, quantized SNN config and (if calibrated) the
        matched-profile table — to one .npz.  The reference has no model
        persistence at all (designs are recomputed every process start,
        SURVEY §5); this is the deployment checkpoint."""
        cfg = self.xylo_config
        arrays = {
            "r_vec": self.geometry.r_vec,
            "theta_vec": self.geometry.theta_vec,
            "speed": np.asarray(self.geometry.speed),
            "freq_bands": self.freq_bands,
            "doa_list": self.doa_list,
            "params": np.asarray(
                [self.recording_duration, self.kernel_duration, float(self.fs),
                 float(self.bipolar_spikes), cfg.dt]
            ),
            "w_in": cfg.w_in,
            "w_rec": cfg.w_rec,
            "w_out": cfg.w_out,
            "dash_syn": cfg.dash_syn,
            "dash_mem": cfg.dash_mem,
            "dash_syn_out": cfg.dash_syn_out,
            "dash_mem_out": cfg.dash_mem_out,
            "threshold": cfg.threshold,
            "threshold_out": cfg.threshold_out,
            "weight_scale": np.asarray(cfg.weight_scale),
        }
        for i, m in enumerate(self.bf_mats):
            arrays[f"bf_{i}"] = m
        if getattr(self, "_profiles", None) is not None:
            arrays["profiles"] = np.asarray(self._profiles)
        if getattr(self, "_profiles_stacked", None) is not None:
            arrays["profiles_stacked"] = np.asarray(self._profiles_stacked)
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str):
        """Reconstruct a Demo from :meth:`save` output without re-running the
        design (the quantized config and matrices are restored verbatim)."""
        from ...geometry import ArrayGeometry
        from .quantize import XyloConfig

        z = np.load(path, allow_pickle=False)
        geometry = ArrayGeometry(z["r_vec"], z["theta_vec"], float(z["speed"]))
        rec_dur, ker_dur, fs, bipolar, dt = z["params"]

        self = cls.__new__(cls)
        self.geometry = geometry
        self.freq_bands = np.atleast_2d(z["freq_bands"])
        self.doa_list = np.asarray(z["doa_list"])
        self.recording_duration = float(rec_dur)
        self.kernel_duration = float(ker_dur)
        self.bipolar_spikes = bool(bipolar)
        self.xylosim_version = True
        self.fs = float(fs)
        self.dt = 1.0 / self.fs

        self.bf_mats = []
        i = 0
        while f"bf_{i}" in z:
            self.bf_mats.append(z[f"bf_{i}"])
            i += 1
        self.tau_vecs = np.asarray(
            [[1.0 / (2 * np.pi * float(np.mean(b)))] * 2 for b in self.freq_bands]
        )
        self.beamfs = [
            SNNBeamformer(
                geometry=geometry,
                kernel_duration=self.kernel_duration,
                freq_range=band,
                tau_vec=list(tv),
                bipolar_spikes=self.bipolar_spikes,
                fs=self.fs,
            )
            for band, tv in zip(self.freq_bands, self.tau_vecs)
        ]
        self.filterbank = ButterworthFilterbank(
            freq_bands=self.freq_bands, order=1, fs=self.fs
        )
        self._bas = tuple(
            (tuple(b.tolist()), tuple(a.tolist())) for b, a in self.filterbank.ba_list
        )
        self.xylo_config = XyloConfig(
            w_in=z["w_in"], w_rec=z["w_rec"], w_out=z["w_out"],
            dash_syn=z["dash_syn"], dash_mem=z["dash_mem"],
            dash_syn_out=z["dash_syn_out"], dash_mem_out=z["dash_mem_out"],
            threshold=z["threshold"], threshold_out=z["threshold_out"],
            dt=float(dt), weight_scale=float(z["weight_scale"]),
        )
        self.xylo = XyloSim.from_config(self.xylo_config, output_mode="Spike", dt=float(dt))
        if "profiles" in z:
            self._profiles = np.asarray(z["profiles"])
        if "profiles_stacked" in z:
            self._profiles_stacked = np.asarray(z["profiles_stacked"])
        return self

    # ------------------------------------------------------ matched profiles
    def calibrate_profiles(self, template=None, batch: int = 32, use_cache: bool = True,
                           band_stacked: bool = False):
        """Build the G×G matched-profile table: row g = the hidden-rate profile
        the quantized pipeline produces for a noiseless source at grid DoA g.

        This is an *improvement over the reference*: its peak/argmax estimators
        inherit the systematic profile warp of the integer dynamics (dash
        quantization, threshold crossing nonlinearity), which shows up as a
        few-degree absolute bias.  Correlating the measured profile against
        calibrated templates removes the bias by construction.  Calibration
        costs one batched noiseless forward per grid point (~0.1 s of device
        time at benchmark scale) and is cached with the design.

        ``band_stacked=True`` (multi-band only) calibrates a G×(F·G) table of
        the *unfolded* per-band hidden rates instead of the reference's
        band-averaged fold (micloc/xylo_snn_localization.py:379-398 folds F
        band blocks into one G profile before estimating).  Scoring is
        per-band cosine (:func:`_blockcos`): each band's angular response is
        matched in its own coordinates and contributes a bounded term, so a
        noise-dominated band cannot swamp the summed score.  Stored as
        ``_profiles_stacked`` and used by
        ``forward_batch(method="matched_stacked")``.  Measured on the speech
        MC (experiments/multiband_speech.py, 3 bands over 500-3000 Hz):
        sub-1° MAE at ≥ 8 dB where the folded profile gives 2-4°.
        """
        from ...ops.interp import signal_from_template
        from ...utils.cache import DesignCache, design_cache_key

        if template is None:
            t = np.arange(0, self.recording_duration, 1.0 / self.fs)
            f_mid = float(np.mean(self.freq_bands[0]))
            template = (t, np.sin(2 * np.pi * f_mid * t))
        t, sig = template

        cache = DesignCache() if use_cache else None
        key = design_cache_key(
            kind="profiles_stacked" if band_stacked else "profiles",
            r_vec=self.geometry.r_vec,
            theta_vec=self.geometry.theta_vec,
            freq_bands=self.freq_bands,
            doa_list=self.doa_list,
            recording_duration=self.recording_duration,
            kernel_duration=self.kernel_duration,
            bipolar=self.bipolar_spikes,
            fs=self.fs,
            sig=np.asarray(sig, np.float32),
            version=1,
        )
        cached = cache.load(key) if cache else None
        if cached is not None:
            # stored as numpy: the jitted estimators embed the table as a
            # closure literal
            out = np.asarray(cached["profiles"])
            if band_stacked:
                self._profiles_stacked = out
            else:
                self._profiles = out
            return out

        G = len(self.doa_list)
        profs = []
        for start in range(0, G, batch):
            doas = self.doa_list[start : start + batch]
            frames = jnp.stack(
                [
                    signal_from_template(self.geometry, jnp.asarray(t), jnp.asarray(sig), jnp.asarray(d), fs=self.fs)
                    for d in doas
                ]
            )
            if band_stacked:
                rates = self._rates_batch_jit(jnp.asarray(frames, jnp.float32))
            else:
                _, rates = self.forward_batch(frames)
            profs.append(np.asarray(rates))
        profiles = np.concatenate(profs, axis=0)  # (G, G) or (G, F*G)
        # normalize rows (correlation-style matching)
        profiles = profiles - profiles.mean(axis=1, keepdims=True)
        norms = np.linalg.norm(profiles, axis=1, keepdims=True)
        profiles = profiles / np.maximum(norms, 1e-12)
        if cache is not None:
            cache.save(key, {"profiles": profiles})
        out = np.asarray(profiles)
        if band_stacked:
            self._profiles_stacked = out
        else:
            self._profiles = out
        return out

    def _check_channels(self, sig_in) -> None:
        """Reject mismatched mic counts EARLY with a clean error: the
        per-channel encode happily processes any width (it only fails — or
        silently mis-broadcasts — channels deep into the LIF input matmul).
        The reference has no such check (its scipy loop raises an opaque
        shape error from inside lfilter)."""
        M = len(self.geometry)
        if sig_in.ndim != 2 or sig_in.shape[-1] != M:
            raise ValueError(
                f"sig_in must be (T, {M}) for this {M}-mic geometry; got "
                f"{tuple(sig_in.shape)}"
            )

    # ------------------------------------------------------------- jitted path
    def forward(self, sig_in):
        """Whole chain as one jitted call: (T, M) audio → (doa, rate).

        This is the flagship benchmarked program — no host round-trips between
        stages (the reference crosses Python/rockpool boundaries per stage).
        """
        sig_in = jnp.asarray(sig_in, jnp.float32)
        self._check_channels(sig_in)
        return self._forward_jit(sig_in)

    @functools.cached_property
    def _forward_jit(self):
        # the single-frame chain is the batched one at B = 1
        batch = self._forward_batch_jit

        @jax.jit
        def fwd(sig_in):
            doa, rate_doa = batch(sig_in[None])
            return doa[0], rate_doa[0]

        return fwd

    @functools.cached_property
    def _forward_matched_jit(self):
        """Single-frame flagship chain with the calibrated matched estimator
        (bias-free; requires :meth:`calibrate_profiles`)."""
        if getattr(self, "_profiles", None) is None:
            raise ValueError("call calibrate_profiles() before the matched forward")
        base = self._forward_jit
        # numpy closures keep the lowered programs (and their cache keys)
        # free of device-resident literals
        profiles = np.asarray(self._profiles, np.float32)
        doa_list = np.asarray(self.doa_list)

        @jax.jit
        def fwd(sig_in):
            _, rate_doa = base(sig_in)
            r = rate_doa - jnp.mean(rate_doa)
            scores = jnp.matmul(
                jnp.asarray(profiles), r, precision=jax.lax.Precision.HIGHEST
            )
            doa = jnp.asarray(doa_list)[jnp.argmax(scores)]
            return doa, rate_doa

        return fwd

    def forward_batch(self, sig_batch, method: str = "peak"):
        """Batched flagship chain: (B, T, M) → (doa (B,), rate (B, G)).

        ``method="peak"`` is the reference-parity argmax estimator
        (micloc/xylo_snn_localization.py:400-444); ``method="matched"`` applies
        the calibrated matched-profile estimator inside the same jitted
        program (requires :meth:`calibrate_profiles`);
        ``method="matched_stacked"`` matches the unfolded per-band rates
        against the G×(F·G) stacked table (requires
        ``calibrate_profiles(band_stacked=True)``; the returned rate is still
        the reference-folded (B, G) profile)."""
        sig_batch = jnp.asarray(sig_batch, jnp.float32)
        if method == "matched":
            return self._forward_batch_matched_jit(sig_batch)
        if method == "matched_stacked":
            return self._forward_batch_matched_stacked_jit(sig_batch)
        if method == "matched_auto":
            return self._forward_batch_matched_auto_jit(sig_batch)
        return self._forward_batch_jit(sig_batch)

    @functools.cached_property
    def _forward_batch_matched_jit(self):
        if getattr(self, "_profiles", None) is None:
            raise ValueError("call calibrate_profiles() before the matched forward")
        base = self._forward_batch_jit
        profiles = np.asarray(self._profiles, np.float32)
        doa_list = np.asarray(self.doa_list)

        @jax.jit
        def fwd(sig_batch):
            _, rate_doa = base(sig_batch)
            r = rate_doa - jnp.mean(rate_doa, axis=-1, keepdims=True)
            # (B, G) correlation against calibrated rows; f32-exact since the
            # a TF32 matmul can flip near-tie argmaxes on the DoA grid
            scores = jnp.matmul(
                r, jnp.asarray(profiles).T, precision=jax.lax.Precision.HIGHEST
            )
            doa = jnp.asarray(doa_list)[jnp.argmax(scores, axis=-1)]
            return doa, rate_doa

        return fwd

    @functools.cached_property
    def _rates_batch_jit(self):
        """(B, T, M) audio → UNFOLDED hidden-rate matrix (B, H) with
        H = F·G band blocks in band-major order (the pre-fold quantity of
        micloc/xylo_snn_localization.py:379-398).  Shared body of every
        batched forward; the folded paths are thin wrappers."""
        kernel = np.asarray(self.beamfs[0].kernel, dtype=np.float32)
        cfg = self.xylo_config
        bas = self._bas
        robust_width = self.beamfs[0].robust_width
        bipolar = self.bipolar_spikes
        fs = self.fs

        from ...ops.pallas.lif_kernel import lif_count_rates, lif_count_rates_bipolar
        from ...ops.peaks import (
            local_extrema_mask_bounded,
            rzcc_encode_bipolar_tm,
            select_by_distance_tm,
        )

        @jax.jit
        def rates(sig_batch):
            # time-major end to end: the encode is naturally (T, ...) inside,
            # so vmapping to (T, B, C) costs nothing, and the RZCC masks feed
            # the LIF kernel in its (T, B, C) layout
            cs_tm = jax.vmap(
                lambda s: _encode_cumsum(s, kernel, bas=bas, time_major=True),
                out_axes=1,
            )(sig_batch)  # (T, B, C)
            T, B, C = cs_tm.shape
            cs_rows = cs_tm.reshape(T, B * C)
            if bipolar:
                kp, kn = rzcc_encode_bipolar_tm(cs_rows, robust_width, 2 * robust_width)
                counts = lif_count_rates_bipolar(
                    cfg, kp.reshape(T, B, C), kn.reshape(T, B, C), spike_bound=1
                )
            else:
                maxima, _ = local_extrema_mask_bounded(cs_rows.T, 2 * robust_width)
                kp = select_by_distance_tm(maxima.T, cs_rows, robust_width)
                counts = lif_count_rates(
                    cfg, kp.reshape(T, B, C), time_major=True, spike_bound=1
                )
            return counts.astype(jnp.float32) / T * fs

        return rates

    @functools.cached_property
    def _forward_batch_jit(self):
        rates_fn = self._rates_batch_jit
        doa_list = np.asarray(self.doa_list)
        num_DoA = len(self.doa_list)

        @jax.jit
        def fwd(sig_batch):
            rate = rates_fn(sig_batch)
            rate_doa = rate.reshape(rate.shape[0], -1, num_DoA).mean(1)
            doa = jnp.asarray(doa_list)[jnp.argmax(rate_doa, axis=-1)]
            return doa, rate_doa

        return fwd

    @functools.cached_property
    def _forward_batch_matched_stacked_jit(self):
        """Batched forward with the band-stacked matched estimator: the
        UNFOLDED (B, F·G) rates are matched against the G×(F·G) stacked
        calibration table (see :meth:`calibrate_profiles`) with PER-BAND
        COSINE scoring (:func:`_blockcos`) — each band's angular response is
        matched in its own coordinates and contributes a bounded cosine to
        the summed score.  Returns (doa (B,), folded rate (B, G)) — same
        contract as the other batched forwards."""
        if getattr(self, "_profiles_stacked", None) is None:
            raise ValueError(
                "call calibrate_profiles(band_stacked=True) before the "
                "stacked matched forward"
            )
        rates_fn = self._rates_batch_jit
        doa_list = np.asarray(self.doa_list)
        num_DoA = len(self.doa_list)
        prof = np.asarray(self._profiles_stacked, np.float32)
        pb = prof.reshape(prof.shape[0], -1, num_DoA)
        pb = pb - pb.mean(axis=-1, keepdims=True)
        pb = pb / np.maximum(np.linalg.norm(pb, axis=-1, keepdims=True), 1e-12)
        prof_cos_np = pb.reshape(prof.shape)

        @jax.jit
        def fwd(sig_batch):
            rate = rates_fn(sig_batch)
            rc = _blockcos(rate, num_DoA)
            # (B, H) @ (H, G); f32-exact — TF32 can flip near-ties
            scores = jnp.matmul(
                rc, jnp.asarray(prof_cos_np).T,
                precision=jax.lax.Precision.HIGHEST,
            )
            doa = jnp.asarray(doa_list)[jnp.argmax(scores, axis=-1)]
            rate_doa = rate.reshape(rate.shape[0], -1, num_DoA).mean(1)
            return doa, rate_doa

        return fwd

    @functools.cached_property
    def _forward_batch_matched_auto_jit(self):
        """Batched forward with the SNR-ADAPTIVE blend estimator
        (:func:`_auto_blend_scores`): per-band cosine evidence + the folded
        cosine, each weighted by its own achieved confidence — tracks the
        folded estimator at very low SNR and the per-band-cosine stacked one
        at moderate/high SNR without an SNR oracle.  Requires
        ``calibrate_profiles(band_stacked=True)``; returns (doa (B,), folded
        rate (B, G)) like the other batched forwards."""
        if getattr(self, "_profiles_stacked", None) is None:
            raise ValueError(
                "call calibrate_profiles(band_stacked=True) before the "
                "auto-blend matched forward"
            )
        rates_fn = self._rates_batch_jit
        doa_list = np.asarray(self.doa_list)
        num_DoA = len(self.doa_list)
        prof_np = np.asarray(self._profiles_stacked, np.float32)

        @jax.jit
        def fwd(sig_batch):
            rate = rates_fn(sig_batch)
            scores = _auto_blend_scores(rate, jnp.asarray(prof_np), num_DoA)
            doa = jnp.asarray(doa_list)[jnp.argmax(scores, axis=-1)]
            rate_doa = rate.reshape(rate.shape[0], -1, num_DoA).mean(1)
            return doa, rate_doa

        return fwd
