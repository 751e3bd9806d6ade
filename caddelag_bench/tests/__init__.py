"""CPU tests of the port's benchmark (``python -m pytest caddelag_bench/tests``)."""
