"""Command-line tools of the port: the dataset reader demo, the sample
trajectory extractor, the collection campaign's restarting runner, the
flagship's rebuild recipe (``bench_model``) and the tail's timing
(``bench_tail``).  Run each with ``python -m
visual_foresight_torch.tools.<name>``."""
