"""The benchmark's plain reference: what ``correct`` is decided against.

Frozen plain-PyTorch copies of the model code of ``vits_torch`` as it stood
when the benchmark was written (``models/``, ``ops/``, ``training/losses.py``,
``text/``), with the imports pointed here, MAS as a plain dynamic program
(``ops/mas.py``), one AdamW step written out (``step.py``), the serving
semantics of the engine for one request at a time (``serve.py``), and the
yardstick's arithmetic: the FLOP count of a train step (``flops.py``) and
the card's peaks and the MAS byte bound (``peaks.py``).

Nothing here imports ``vits_torch``, ``vits_tpu`` or JAX, and nothing here is
edited when the program changes: the reference is what a change of the
program is held to. It runs in float32 with TF32 off (``precision.py``).
"""
