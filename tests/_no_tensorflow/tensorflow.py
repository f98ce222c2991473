"""Stands in for TensorFlow in the port's test subprocesses (on their
PYTHONPATH through ``tests/_torch_ranks.py::subprocess_env``): importing it
fails, so tensorboard writes its summaries through its own stub instead of
loading TensorFlow."""

raise ImportError("TensorFlow is hidden from the port's test subprocesses")
