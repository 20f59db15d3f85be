"""Synthetic inputs made from the run's seed, written with the benchmark's
own frozen writers so that no change to the port moves them."""
