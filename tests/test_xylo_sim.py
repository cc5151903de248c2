"""Pin the integer-LIF step convention and verify the alternative-ordering
flags used by experiments/xylo_ordering_sensitivity.py.

The DEFAULT convention (decay_first / subtract) is the documented LIFBitshift
step the simulator asserts (models/xylo/sim.py): per step
``isyn ← sat(isyn − (isyn >> ds) + inp + rec)``,
``vmem ← sat(vmem − (vmem >> dm) + isyn)``, spike at ``vmem ≥ thr``,
membrane subtract-reset.  A hand-rolled numpy golden pins it bit-exactly here
so it cannot drift; the variant flags must produce *different* dynamics on a
discriminating input (otherwise the sensitivity study measures nothing).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from haghighatshoarmuir2024.models.xylo.quantize import XyloConfig
from haghighatshoarmuir2024.models.xylo.sim import XyloSim, sim_hidden_batch


def _tiny_config(n_in=4, n_hid=6, n_out=2, seed=0):
    rng = np.random.default_rng(seed)
    return XyloConfig(
        w_in=rng.integers(-30, 31, size=(n_in, n_hid)).astype(np.int32),
        w_rec=np.zeros((n_hid, n_hid), np.int32),
        w_out=rng.integers(-30, 31, size=(n_hid, n_out)).astype(np.int32),
        dash_syn=rng.integers(1, 5, size=n_hid).astype(np.int32),
        dash_mem=rng.integers(1, 5, size=n_hid).astype(np.int32),
        dash_syn_out=np.ones(n_out, np.int32),
        dash_mem_out=np.ones(n_out, np.int32),
        threshold=np.full(n_hid, 40, np.int32),
        threshold_out=np.full(n_out, 40, np.int32),
        dt=1e-3,
        weight_scale=1.0,
    )


def _numpy_golden(cfg, spikes_in, ordering="decay_first", reset="subtract"):
    """Serial numpy twin of models/xylo/sim._sim_hidden."""
    T = spikes_in.shape[0]
    n = cfg.n_hidden
    isyn = np.zeros(n, np.int64)
    vmem = np.zeros(n, np.int64)
    out = np.zeros((T, n), np.int32)
    sat = lambda x: np.clip(x, -(2**15), 2**15 - 1)
    inp = spikes_in.astype(np.int64) @ cfg.w_in.astype(np.int64)
    for t in range(T):
        if ordering == "decay_first":
            isyn = sat(isyn - (isyn >> cfg.dash_syn) + inp[t])
            vmem = sat(vmem - (vmem >> cfg.dash_mem) + isyn)
        else:
            x = sat(isyn + inp[t])
            isyn = sat(x - (x >> cfg.dash_syn))
            y = sat(vmem + isyn)
            vmem = sat(y - (y >> cfg.dash_mem))
        spk = (vmem >= cfg.threshold).astype(np.int32)
        if reset == "subtract":
            vmem = vmem - spk * cfg.threshold
        else:
            vmem = np.where(spk > 0, 0, vmem)
        out[t] = spk
    return out


@pytest.fixture(scope="module")
def setup():
    cfg = _tiny_config()
    rng = np.random.default_rng(1)
    spikes_in = (rng.random((200, cfg.n_in)) < 0.3).astype(np.int32)
    return cfg, spikes_in


def test_default_convention_bit_exact(setup):
    cfg, spikes_in = setup
    sim = XyloSim(cfg)
    _, _, rec = sim(spikes_in)
    golden = _numpy_golden(cfg, spikes_in)
    np.testing.assert_array_equal(np.asarray(rec["Spikes"]), golden)
    assert sim.ordering == "decay_first" and sim.reset == "subtract"


@pytest.mark.parametrize("ordering", ["decay_first", "integrate_first"])
@pytest.mark.parametrize("reset", ["subtract", "zero"])
def test_variants_bit_exact(setup, ordering, reset):
    cfg, spikes_in = setup
    sim = XyloSim(cfg, ordering=ordering, reset=reset)
    _, _, rec = sim(spikes_in)
    golden = _numpy_golden(cfg, spikes_in, ordering=ordering, reset=reset)
    np.testing.assert_array_equal(np.asarray(rec["Spikes"]), golden)


def test_variants_discriminate(setup):
    """The alternative conventions genuinely alter the dynamics on a
    bursty input (so the sensitivity experiment measures something)."""
    cfg, _ = setup
    rng = np.random.default_rng(2)
    # bursty drive: long quiet stretches + strong bursts → decay placement
    # and reset semantics both bite
    burst = (rng.random((400, cfg.n_in)) < 0.05).astype(np.int32) * 3
    base = _numpy_golden(cfg, burst, "decay_first", "subtract")
    alt_o = _numpy_golden(cfg, burst, "integrate_first", "subtract")
    alt_r = _numpy_golden(cfg, burst, "decay_first", "zero")
    assert np.any(base != alt_o)
    assert np.any(base != alt_r)


def test_batch_variant_flags(setup):
    cfg, spikes_in = setup
    batch = np.stack([spikes_in, spikes_in[::-1]])
    spk = np.asarray(
        sim_hidden_batch(cfg, batch, ordering="integrate_first", reset="zero")
    )
    g0 = _numpy_golden(cfg, batch[0], "integrate_first", "zero")
    g1 = _numpy_golden(cfg, batch[1], "integrate_first", "zero")
    np.testing.assert_array_equal(spk[0], g0)
    np.testing.assert_array_equal(spk[1], g1)
