"""Command-line tools of the port: the dataset reader demo, the sample
trajectory extractor, the collection campaign's restarting runner, the
flagship's rebuild recipe (``bench_model``), the tail's timing
(``bench_tail``) and the multi-device dry run (``dryrun_multichip``).  Run each with ``python -m
visual_foresight_torch.tools.<name>``."""
