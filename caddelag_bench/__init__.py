"""The port's benchmark: harness, generator, reference and readers (see ``run.py``)."""
