"""The port's build of the repository's native (C++) graph engine
(``graph.py``), the counterpart of ``paddlerec_tpu/native/``."""
