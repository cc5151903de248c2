"""Tests: peak location, benchmark statistics (validated against the
reference's committed benchmark data), design cache, mesh + Monte Carlo."""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from haghighatshoarmuir2024.utils import (
    DesignCache,
    analyze_doa_samples,
    design_cache_key,
    find_peak_location,
    window_median,
)

REF_DATA = "/root/reference/paper_plots/demo-benchmark-simulation-freq1600-2000"


def _ref_find_peak_location(sig_in, win_size, periodic=True):
    """Port of micloc/utils.py:84-121."""
    window = np.ones(win_size)
    sig_avg = np.convolve(window, sig_in, mode="full")
    index = np.argmax(sig_avg) - win_size // 2
    if periodic:
        index = index % len(sig_in)
    return index


@pytest.mark.parametrize("seed", range(4))
def test_find_peak_location_matches_reference(seed):
    rng = np.random.default_rng(seed)
    sig = rng.random(301)
    for win in (3, 9, 25):
        ref = _ref_find_peak_location(sig, win)
        got = int(find_peak_location(jnp.asarray(sig), win))
        assert got == ref


def test_find_peak_location_validations():
    with pytest.raises(ValueError):
        find_peak_location(jnp.zeros((3, 3)), 3)
    with pytest.raises(ValueError):
        find_peak_location(jnp.zeros(100), 4)  # even window
    with pytest.raises(ValueError):
        find_peak_location(jnp.zeros(10), 9)  # window too large


@pytest.mark.skipif(not os.path.isdir(REF_DATA), reason="reference data not mounted")
def test_analyze_matches_committed_benchmark_numbers():
    """Re-analyzing the reference's committed live-benchmark data must give the
    documented post-processed MAE of 0.43-0.47 deg (BASELINE.md, derived from
    snn_localization_benchmark.py:595-660)."""
    maes = []
    for fname in sorted(os.listdir(REF_DATA)):
        data = np.loadtxt(os.path.join(REF_DATA, fname))
        stats = analyze_doa_samples(data, window_length=25, reject_jump=20.0)
        maes.append(stats["doa_mae_postprocessed"])
        assert 0.5 < stats["robust_std"] < 3.5
    assert all(0.40 <= m <= 0.50 for m in maes), maes


def test_window_median_rejects_jumps():
    x = np.full(100, 10.0)
    x[50] = 500.0  # a jump
    out = window_median(x, 25, reject_jump=20.0)
    assert np.nanmax(out) <= 10.0 + 1e-12


def test_design_cache_roundtrip(tmp_path):
    c = DesignCache(cache_dir=str(tmp_path))
    key = design_cache_key(a=np.arange(5), b="hello", c=1.5)
    assert c.load(key) is None
    c.save(key, {"m": np.eye(3)})
    out = c.load(key)
    np.testing.assert_allclose(out["m"], np.eye(3))
    # different inputs -> different key
    key2 = design_cache_key(a=np.arange(5), b="hello", c=1.6)
    assert key != key2


def test_mesh_and_monte_carlo_sharded():
    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.parallel import (
        make_mesh,
        make_trial_fn,
        monte_carlo_sweep,
    )
    from haghighatshoarmuir2024.models.beamformer import Beamformer

    assert len(jax.devices()) == 8, "conftest must provide the virtual CPU mesh"
    mesh = make_mesh(8, shape=(4, 2))

    fs = 48_000
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    t = np.arange(0, 0.05, 1 / fs)
    sig = np.sin(2 * np.pi * 1750 * t)
    grid = np.linspace(-np.pi, np.pi, 33)
    bf = Beamformer(geometry, 2e-3, (1600, 1900), fs=fs, design_chunk=16)
    bf_mat, _ = bf.design_from_template((t, sig), grid)
    grid_j = jnp.asarray(grid)

    def estimate(sig_in):
        out = bf.apply_to_signal(bf_mat, sig_in)
        p = jnp.mean(jnp.abs(out) ** 2, axis=0)
        return grid_j[jnp.argmax(p)]

    trial = make_trial_fn(geometry, t, sig, estimate, fs)
    res = monte_carlo_sweep(
        trial, snr_db_vec=[20.0, 0.0], num_sims=6, key=jax.random.PRNGKey(0), mesh=mesh
    )
    assert res["errors"].shape == (2, 6)
    # high-SNR trials localize (folded metric; coarse 33-point grid ~ 11 deg)
    assert np.rad2deg(res["mae"][0]) < 12.0


def test_monte_carlo_unsharded_matches_sharded():
    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.parallel import make_mesh, make_trial_fn, monte_carlo_sweep

    fs = 48_000
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    t = np.arange(0, 0.02, 1 / fs)
    sig = np.sin(2 * np.pi * 1750 * t)

    def estimate(s):
        return jnp.asarray(0.5)  # trivial estimator: exercises plumbing only

    trial = make_trial_fn(geometry, t, sig, estimate, fs)
    r1 = monte_carlo_sweep(trial, [10.0], 8, jax.random.PRNGKey(1))
    r2 = monte_carlo_sweep(trial, [10.0], 8, jax.random.PRNGKey(1), mesh=make_mesh(8))
    np.testing.assert_allclose(r1["errors"], r2["errors"], rtol=1e-6)

    # fewer sims than mesh devices: the pad (6) EXCEEDS num_sims (2), which a
    # plain keys[:pad] slice under-fills — the launch must still split the
    # 8-way data axis evenly and return exactly num_sims errors
    r3 = monte_carlo_sweep(trial, [10.0], 2, jax.random.PRNGKey(1), mesh=make_mesh(8))
    assert r3["errors"].shape == (1, 2)
    np.testing.assert_allclose(r3["errors"], r1["errors"][:, :2], rtol=1e-6)


def test_isotonic_pav():
    from haghighatshoarmuir2024.utils import approx_decreasing, isotonic_increasing

    rng = np.random.default_rng(0)
    y = np.sort(rng.standard_normal(50)) + 0.3 * rng.standard_normal(50)
    fit = isotonic_increasing(y)
    assert np.all(np.diff(fit) >= -1e-12)
    # L2 optimality sanity: projection is idempotent and no worse than input
    np.testing.assert_allclose(isotonic_increasing(fit), fit)
    assert np.sum((fit - y) ** 2) <= np.sum((np.sort(y) - y) ** 2) + 1e-9

    dec = approx_decreasing(y[::-1])
    assert np.all(np.diff(dec) <= 1e-12)


def test_stage_timer_and_benchmark():
    import jax.numpy as jnp

    from haghighatshoarmuir2024.utils import StageTimer, benchmark_fn

    st = StageTimer()
    with st.stage("a"):
        _ = jnp.arange(10).sum()
    f = st.timed("b", lambda x: x * 2)
    f(jnp.ones(4))
    rep = st.report()
    assert set(rep) == {"a", "b"} and rep["b"]["calls"] == 1

    import jax

    res = benchmark_fn(jax.jit(lambda x: x + 1), jnp.zeros(128), iters=3)
    assert res["mean_s"] > 0


def test_model_from_config():
    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.config import (
        BeamformerConfig,
        MUSICConfig,
        SNNBeamformerConfig,
    )
    from haghighatshoarmuir2024.models import MUSIC, Beamformer, SNNBeamformer

    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    bf = Beamformer.from_config(BeamformerConfig(), geo)
    assert bf.fs == 48_000 and len(bf.kernel) == 480
    snn = SNNBeamformer.from_config(SNNBeamformerConfig(), geo)
    assert snn.robust_width == (48_000 // 1900) // 2
    m = MUSIC.from_config(MUSICConfig(), geo, np.linspace(-np.pi, np.pi, 8))
    assert m.frame_duration == 0.25


def test_data_parallel_program_partitions_per_device():
    """Structural scaling evidence (single-core host: wall-clock speedup is
    unmeasurable, so assert the compiled SPMD module instead): sharding the
    Monte-Carlo trial axis over 8 virtual devices must give each device a
    1/8 parameter block, with cross-device traffic limited to scalar
    statistics reductions (experiments/multichip_scaling.py records the
    full census)."""
    import re

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from haghighatshoarmuir2024.parallel import make_mesh

    mesh = make_mesh(n_devices=8, shape=(8, 1))
    num_sims = 32
    keys = jax.random.split(jax.random.PRNGKey(0), num_sims)

    def step(keys):
        # representative per-trial compute: synthesize → reduce
        def trial(k):
            x = jax.random.normal(k, (512,))
            return jnp.mean(x**2)

        vals = jax.vmap(trial)(keys)
        return jnp.mean(vals)

    sh = NamedSharding(mesh, P("data", None))
    compiled = (
        jax.jit(step, in_shardings=sh, out_shardings=NamedSharding(mesh, P()))
        .lower(jax.device_put(keys, sh))
        .compile()
    )
    txt = compiled.as_text()
    m = re.search(r"%param[\w.]* = u32\[(\d+),2\]", txt)
    assert m is not None, "trial-key parameter not found in compiled module"
    assert int(m.group(1)) == num_sims // 8  # per-device block = 1/8 of work
    # statistics-only communication: scalar all-reduce, no big all-gathers
    assert re.search(r"f\d+\[\] all-reduce\(", txt)  # f64 under the x64 test config
    for shape in re.findall(r"(\w+)\[([\d,]+)\][^\n]*all-gather\(", txt):
        sizes = [int(s) for s in shape[1].split(",") if s]
        assert np.prod(sizes) <= num_sims, f"large all-gather found: {shape}"


_CACHE_DIR_PROBE = (
    "import jax; jax.config.update('jax_platforms', 'cpu');"
    "from haghighatshoarmuir2024.utils.cache import "
    "enable_persistent_compilation_cache as e; e(); e();"
    "print(jax.config.jax_compilation_cache_dir)"
)


def _probe_cache_dir(env):
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-c", _CACHE_DIR_PROBE], capture_output=True, text=True,
        timeout=120, env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
    )
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_follows_env_dir(tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache directory, and the
    program sets no other."""
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "xla"))
    assert _probe_cache_dir(env) == str(tmp_path / "xla")


def test_compile_cache_default_is_fixed_in_checkout():
    """Without the variable the cache lands at one fixed path inside the
    checkout (gitignored ``.cache/jax``), whatever HOME or the temp dir is."""
    import haghighatshoarmuir2024

    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["HOME"] = env["TMPDIR"] = "/nonexistent-home"
    root = os.path.dirname(os.path.dirname(haghighatshoarmuir2024.__file__))
    assert _probe_cache_dir(env) == os.path.join(root, ".cache", "jax")
