"""One reader a metric (``metrics/<metric>.py``), named as in
BENCHMARK.json.  ``read(run)`` returns the metric's value, or None when
the run has nothing for it to read; ``run`` holds the cell's files and the
ranks' results (``bench/drivers/train.py``)."""
