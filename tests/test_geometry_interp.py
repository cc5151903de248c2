"""Geometry + propagation-model golden tests against a direct NumPy port of the
reference (micloc/array_geometry.py, micloc/beamformer.py:113-129,233-245)."""
import numpy as np
import jax.numpy as jnp

from haghighatshoarmuir2024 import (
    CircularArray,
    CenterCircularArray,
    LinearArray,
)
from haghighatshoarmuir2024.ops import (
    interp_uniform,
    received_signal,
    signal_from_template,
)


def _ref_delays(r_vec, theta_vec, speed, theta, normalized):
    d = -r_vec * np.cos(theta_vec - theta) / speed
    if normalized:
        d -= d.min()
    return d


def test_circular_delays_match_reference():
    geo = CircularArray(radius=4.5e-2, num_mic=7)
    # endpoint quirk: first and last mic coincide (array_geometry.py:76)
    np.testing.assert_allclose(geo.theta_vec[0], 0.0)
    np.testing.assert_allclose(geo.theta_vec[-1], 2 * np.pi)
    for theta in (0.0, 0.7, -2.0, np.pi):
        for normalized in (True, False):
            ref = _ref_delays(geo.r_vec, geo.theta_vec, geo.speed, theta, normalized)
            got = np.asarray(geo.delays(jnp.asarray(theta), normalized=normalized))
            np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-18)


def test_delays_grid_batches():
    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, 449)
    got = np.asarray(geo.delays(jnp.asarray(grid), normalized=True))
    assert got.shape == (449, 7)
    for i in (0, 100, 448):
        ref = _ref_delays(geo.r_vec, geo.theta_vec, geo.speed, grid[i], True)
        np.testing.assert_allclose(got[i], ref, rtol=1e-12, atol=1e-18)


def test_linear_array_folding():
    geo = LinearArray(spacing=1.5e-2, num_mic=7, radius=None)
    # reference folds negative positions into theta=pi (array_geometry.py:112-116)
    r_ref = 1.5e-2 * (np.arange(-3.5, 3.5) + 0.5)
    assert np.all(geo.r_vec >= 0)
    np.testing.assert_allclose(np.sort(geo.r_vec), np.sort(np.abs(r_ref)))


def test_interp_uniform_matches_np_interp():
    rng = np.random.default_rng(0)
    f = rng.standard_normal(500)
    t0, dt = 0.3, 1 / 48_000
    t = t0 + np.arange(500) * dt
    tq = rng.uniform(t0 - 5 * dt, t[-1] + 5 * dt, size=(300,))
    ref = np.interp(tq, t, f)
    got = np.asarray(interp_uniform(jnp.asarray(tq), jnp.asarray(f), t0, dt))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


def _ref_received(geometry, time_temp, sig_temp, doa_temp):
    """Port of micloc/beamformer.py:233-245 (no noise)."""
    if np.ndim(doa_temp) == 0:
        doa_temp = doa_temp * np.ones_like(sig_temp)
    delays = np.asarray(
        [_ref_delays(geometry.r_vec, geometry.theta_vec, geometry.speed, doa, False) for doa in doa_temp]
    )
    delays = delays - delays.min()
    time_delayed = time_temp.reshape(-1, 1) - delays
    time_delayed[time_delayed < time_temp.min()] = time_temp.min()
    return np.interp(time_delayed.ravel(), time_temp, sig_temp).reshape(time_delayed.shape)


def test_received_signal_fixed_doa():
    fs = 48_000
    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    t = np.arange(0, 0.05, 1 / fs)
    sig = np.sin(2 * np.pi * 1750 * t)
    ref = _ref_received(geo, t, sig, 0.7)
    got = np.asarray(
        received_signal(geo, jnp.asarray(t), jnp.asarray(sig), jnp.asarray(0.7), fs=fs)
    )
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10)


def test_received_signal_moving_doa():
    fs = 48_000
    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    t = np.arange(0, 0.03, 1 / fs)
    sig = np.sin(2 * np.pi * 1750 * t)
    doa = np.linspace(-1.0, 1.0, len(t))
    ref = _ref_received(geo, t, sig, doa)
    got = np.asarray(
        received_signal(geo, jnp.asarray(t), jnp.asarray(sig), jnp.asarray(doa), fs=fs)
    )
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10)


def _ref_signal_from_template(geometry, time_temp, sig_temp, doa_temp):
    """Port of micloc/xylo_snn_localization.py:44-71."""
    if np.ndim(doa_temp) == 0:
        doa_temp = doa_temp * np.ones_like(time_temp)
    delays = np.asarray(
        [_ref_delays(geometry.r_vec, geometry.theta_vec, geometry.speed, doa, False) for doa in doa_temp]
    )
    time_delays = time_temp.reshape(-1, 1) + delays
    return np.interp(time_delays.ravel(), time_temp, sig_temp).reshape(*time_delays.shape)


def test_signal_from_template():
    fs = 48_000
    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    t = np.arange(0, 0.04, 1 / fs)
    sig = np.sin(2 * np.pi * 2000 * t)
    for doa in (0.0, 1.3):
        ref = _ref_signal_from_template(geo, t, sig, doa)
        got = np.asarray(signal_from_template(geo, jnp.asarray(t), jnp.asarray(sig), jnp.asarray(doa), fs=fs))
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10)


def test_multipath_single_path_matches_free_field():
    """One path with zero extra delay and unit gain is exactly the free-field
    propagation model."""
    import jax.numpy as jnp

    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.ops.interp import (
        signal_from_template,
        signal_from_template_multipath,
    )

    fs = 48_000
    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    t = np.arange(0, 0.05, 1 / fs)
    sig = np.sin(2 * np.pi * 1750 * t)
    a = signal_from_template(geo, t, sig, 0.8, fs=fs)
    b = signal_from_template_multipath(
        geo, t, sig, jnp.asarray([0.8]), jnp.asarray([0.0]), jnp.asarray([1.0]),
        fs=fs,
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7)


def test_room_image_paths_geometry():
    """Image-source table: direct path first (zero delay, unit gain), 4
    first-order wall images with positive extra delay and gain
    reflection * d_direct/d_image."""
    from haghighatshoarmuir2024.ops.interp import room_image_paths

    doas, extra, gains = room_image_paths(
        source_xy=(3.0, 2.0), array_xy=(1.0, 1.5), room_wh=(5.0, 4.0),
        reflection=0.6, order=1,
    )
    assert len(doas) == 5  # direct + 4 walls
    assert extra[0] == 0.0 and gains[0] == 1.0
    assert np.all(extra[1:] > 0) and np.all(gains[1:] < 0.6 + 1e-12)
    d_direct = np.hypot(3.0 - 1.0, 2.0 - 1.5)
    # wall x=0 image at (-3, 2)
    d_img = np.hypot(-3.0 - 1.0, 2.0 - 1.5)
    k = np.argmin(np.abs(doas - np.arctan2(2.0 - 1.5, -3.0 - 1.0)))
    np.testing.assert_allclose(gains[k], 0.6 * d_direct / d_img, rtol=1e-12)
    np.testing.assert_allclose(extra[k], (d_img - d_direct) / 340.0, rtol=1e-12)
    # second order adds the double-bounce images
    doas2, _, _ = room_image_paths(
        source_xy=(3.0, 2.0), array_xy=(1.0, 1.5), room_wh=(5.0, 4.0),
        reflection=0.6, order=2,
    )
    assert len(doas2) > len(doas)


def test_multipath_localization_still_finds_direct_path():
    """With modest reflections (0.5) the Hilbert beamformer still localizes
    the DIRECT DoA — the framework's pipelines run unchanged on reverberant
    input (the reference cannot synthesize this case at all)."""
    import jax.numpy as jnp

    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.models.beamformer import Beamformer
    from haghighatshoarmuir2024.ops.interp import (
        room_image_paths,
        signal_from_template_multipath,
    )

    fs = 48_000
    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    bf = Beamformer(geo, kernel_duration=10e-3, freq_range=(1600, 1900), fs=fs)
    t = np.arange(0, 0.25, 1 / fs)
    sig = np.sin(2 * np.pi * 1750 * t)
    grid = np.linspace(-np.pi, np.pi, 113)
    bf_mat, _ = bf.design_from_template((t, sig), grid)

    source, array_c, room = (3.0, 2.0), (1.0, 1.5), (5.0, 4.0)
    doas, extra, gains = room_image_paths(source, array_c, room,
                                          reflection=0.5, order=1)
    doa_true = float(doas[0])
    sig_in = signal_from_template_multipath(
        geo, t, sig, jnp.asarray(doas), jnp.asarray(extra), jnp.asarray(gains),
        fs=fs,
    )
    out = bf.apply_to_signal(bf_mat, sig_in)
    power = jnp.mean(jnp.abs(out) ** 2, axis=0)
    est = grid[int(jnp.argmax(power))]
    err = np.degrees(np.arcsin(np.abs(np.sin(est - doa_true))))
    assert err < 10.0, (est, doa_true, err)
