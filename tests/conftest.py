"""Test configuration.

Tests run on a virtual 8-device CPU mesh (multi-chip sharding validated
without hardware) with x64 enabled so golden comparisons against
scipy/numpy float64 references are exact to tolerance.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import pytest

# the config wins over anything else that set the platform before import
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu", jax.devices()


# --------------------------------------------------------------- slow marker
# Suite triage: tests measured > ~5 s on the 2-vCPU dev host
# are auto-marked `slow` here (single point of truth; no per-file decorator
# drift).  `pytest -m "not slow"` is the fast lane (< 3 min); the full suite
# stays the merge gate.  Names are ORIGINAL names (parametrized variants of a
# listed name are all marked).
_SLOW_TESTS = {
    "test_server_matched_stacked_multiband",
    "test_server_two_streams_localize",
    "test_server_forget_tracks_moving_source",
    "test_server_slot_reset_on_reconnect",
    "test_server_multichip_mesh_localizes",
    "test_server_survives_client_fuzz",
    "test_speech_beam_profiles",
    "test_multiband_speech_experiment_tiny",
    "test_sharded_serving_step_matches_unsharded",
    "test_streaming_unipolar_and_multiband",
    "test_batched_streams_match_single",
    "test_streaming_spikes_match_offline",
    "test_streaming_seam_divergence_contained",
    "test_matched_auto_estimator",
    "test_band_stacked_matched_estimator",
    "test_stacked_estimator_eager_chain_matches_batch",
    "test_distance_with_ties",
    "test_rzcc_matches_reference",
    "test_distance_on_bandpassed_cumsum",
    "test_bounded_variants_match_full",
    "test_snn_demo_end_to_end",
    "test_snn_doa_estimation",
    "test_lif_stateful_bipolar_chunked_equals_combined",
    "test_lif_count_interpret_time_chunk_invariance",
    "test_reverb_robustness_tiny",
    "test_mismatch_robustness_tiny",
    "test_doa_estimation_accuracy",
    "test_music_noise_subspace_variant",
    "test_iir_cumsum_level2_matches_level1",
    "test_iir_cumsum_blocked_nondefault_block_sizes",
    "test_distance_matches_scipy",
    "test_mesh_and_monte_carlo_sharded",
    "test_rzcc_under_jit_and_vmap",
    # 24 kHz reduced-rate mode: module fixture designs + calibrates a demo
    "test_server_reduced_rate_24k",
    "test_taus_nondegenerate_at_24k",
    "test_matched_estimator_localizes_at_24k",
    "test_48k_field_input_decimates_to_24k_mode",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: > ~5 s on the dev host; deselect with -m 'not slow'"
    )


def pytest_collection_modifyitems(config, items):
    for item in items:
        name = getattr(item, "originalname", None) or item.name
        if name.split("[")[0] in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
