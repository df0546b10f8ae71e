"""Test harness config: run everything on an 8-device virtual CPU mesh.

The environment preloads jax at interpreter start (so JAX_PLATFORMS from
the env is already captured); ``jax.config.update`` is the reliable way to
force the CPU platform, and XLA_FLAGS is still read lazily at backend init.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


def _isolate_manifest_pin_store():
    # the manifest's trust-on-first-use pin store defaults to a repo-root
    # file; tests must never write it (it records REAL-data first-fetch
    # checksums) — point it into a throwaway location for the whole run
    import tempfile

    os.environ["FGP_MANIFEST_PINS"] = os.path.join(
        tempfile.mkdtemp(prefix="fgp_test_pins_"), "pins.json")


_isolate_manifest_pin_store()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: end-to-end training / multi-minute tests, excluded from the "
        "fast contract tier (`make test-fast` / `-m 'not slow'`)",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the PyTorch port's kernels); skips "
        "without one — run on the card with `-m gpu`",
    )


# Tests >=10s on the 1-CPU reference host (measured 2026-08-17,
# `--durations=40`): the slow tier.  Everything else forms the <5-min
# fast contract suite.  (test_dryrun_multichip_8 and test_entry_compiles
# stay fast deliberately — they are THE driver contracts.)
_SLOW = {
    ("test_reference_parity.py", "test_end_to_end_gp_training_parity"),
    ("test_reference_parity.py", "test_end_to_end_training_parity"),
    ("test_gp.py", "test_composite_exact_gp_kind"),
    ("test_gp.py", "test_deep_gp_multilayer"),
    ("test_graft_entry.py", "test_dryrun_multichip_odd_and_single"),
    ("test_graft_entry.py", "test_dryrun_multichip_4"),
    ("test_harness.py", "test_study_resume_skips_completed_trials"),
    ("test_harness.py", "test_harness_end_to_end"),
    ("test_model_and_train.py", "test_gradients_flow_through_gp"),
    ("test_model_and_train.py", "test_multilayer_gp_composite_end_to_end"),
    ("test_multiseed.py", "test_multiseed_harness_matches_sequential_harness"),
    ("test_multiseed.py", "test_multiseed_matches_sequential_trainers"),
    ("test_fused_gp.py", "test_deep_gp_fused_matches_xla_path"),
    ("test_fused_gp.py", "test_fused_multilayer_falls_back_cleanly"),
    ("test_fedformer_wavelet.py", "test_fedformer_versions"),
    ("test_fedformer_wavelet.py", "test_informer_stack"),
    ("test_pallas_kernels.py", "test_conv_family_pallas_attention_matches_xla"),
    ("test_predict.py", "test_inference_session_end_to_end"),
    ("test_harness_surfaces.py", "test_evaluate_checkpoints_roundtrip"),
    ("test_harness_surfaces.py", "test_cli_end_to_end"),
    ("test_parallel.py", "test_cli_dp_tp_mesh_end_to_end"),
    ("test_parallel.py", "test_sharded_loss_matches_single_device"),
    # second trim (first fast-tier timing came in at 6m35s): moderate
    # 5-45s tests whose coverage the slow tier / driver retains
    ("test_graft_entry.py", "test_dryrun_multichip_8"),
    ("test_harness_surfaces.py", "test_baselines_harness"),
    ("test_fedformer_wavelet.py",
     "test_multiwavelet_transform_self_attention_iface"),
    ("test_fedformer_wavelet.py", "test_mwtcz_roundtrip_shape"),
    ("test_model_and_train.py", "test_lstm_backbone_composite"),
    ("test_model_and_train.py", "test_forecast_denoising_modes"),
    ("test_pallas_kernels.py", "test_rbf_pallas_gradients_match"),
    ("test_baselines.py", "test_deepar_forward_and_nll"),
    # third trim (fast tier crept to 5m51s as guard/quantize/multiseed
    # suites grew): full-training-loop tests whose contract behavior is
    # covered by cheaper siblings left in the fast tier
    ("test_nonfinite_guard.py", "test_multiseed_guard"),
    ("test_nonfinite_guard.py", "test_skip_matches_off_on_clean_data"),
    ("test_quantize.py", "test_int8_session_close_to_fp32_session"),
    ("test_multiseed.py", "test_multiseed_eval_and_divergence"),
    # session additions that mirror already-slow-tiered siblings
    ("test_parallel.py", "test_fsdp_cli_end_to_end"),
    ("test_parallel.py", "test_fsdp_loss_and_grads_match_single_device"),
    ("test_predict.py", "test_export_serving_int8_round_trip"),
    ("test_baselines.py", "test_cmgp_nll_training_step_reduces_loss"),
    # round-4 trim (fast tier crept to 5m22s): the two largest grown
    # tests; sharded-parity coverage stays via the loss/grads siblings in
    # the slow tier + the driver's own dryrun_multichip contract, and
    # ls_init=auto is an opt-in research knob
    ("test_parallel.py", "test_sharded_gradients_match"),
    ("test_gp.py", "test_ls_init_auto_engages_the_gp"),
}


def pytest_collection_modifyitems(config, items):
    import pytest

    for item in items:
        fname = os.path.basename(str(item.fspath))
        base = item.name.split("[")[0]
        if (fname, base) in _SLOW:
            item.add_marker(pytest.mark.slow)
