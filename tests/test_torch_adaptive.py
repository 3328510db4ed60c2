"""The port held against ``tests/test_adaptive.py``: each of its tests
runs on the reference and, retargeted, on the port, and the two runs
must answer alike (``test_torch_parity.mirror``)."""
from test_torch_parity import mirror, mirror_env  # noqa: F401

globals().update(mirror("test_adaptive", numpy_too=(
    "test_adaptive_matches_static_and_rederives_fanout",
    "test_per_stage_timings_in_result",
    "test_duplicate_execution_idempotent_first_writer_wins",
    "test_targeted_repair_beats_stage_rerun_under_drops",
    "test_build_flip_when_size_estimates_inverted",
    "test_flip_not_taken_when_estimates_were_right",
    "test_demotion_where_static_crashes",
    "test_demotion_keeps_honest_layout_elided",
    "test_explain_renders_adaptive_section",
    "test_serve_report_carries_adaptive_counters")))
