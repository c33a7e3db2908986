"""The port's tools, each run with ``python -m``: the long-lived entry
points, the serving daemon (``serve``) and the resumable dataset sweep
(``sweep``); the accuracy and validation tools (``card_fuzz``,
``fuzz_pipeline``, ``flagship_sharded_check``, ``run_baseline_configs``,
``pin_sep_accuracy``, ``sym_vs_leftonly``, ``compare_opencv``,
``refuse_curve``, ``dataset_roundtrip``); and the serving and timing tools
(``serve_bench``, ``serve_soak`` with ``soak_runner``, ``profile_stages``,
``bench_separable``, ``headline_variance``, ``warm_on_compute_change``).
They share ``common``."""
