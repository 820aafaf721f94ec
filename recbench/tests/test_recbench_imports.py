"""Nothing the harness loads is JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and a run
without a card fails without a result."""

import glob
import os
import subprocess
import sys

import pytest

from recbench import harness

CHECK = """
import sys, glob, os
sys.path.insert(0, {root!r})
from recbench import harness
from recbench.tests.small import run_small
for path in sorted(glob.glob(os.path.join(harness.HERE, "**", "*.py"), recursive=True)):
    if "/tests/" not in path:
        harness.load_file_module(path)
for w in ("dlrm_mlperf.train", "dlrm_mlperf.score"):
    run_small(w)
print("LOADED", ",".join(harness.forbidden_modules()))
"""


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_no_jax_after_a_run_of_every_driver():
    out = subprocess.run([sys.executable, "-c", CHECK.format(root=harness.ROOT)],
                         capture_output=True, text=True, timeout=600, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED"


def test_forbidden_compares_whole_names():
    sys.modules.setdefault("paddlerec_tpu_torch_fake_for_test", sys)
    try:
        assert "paddlerec_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["paddlerec_tpu_torch_fake_for_test"]


def test_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would find it")
    out = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                          "dlrm_mlperf.score", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=_env())
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_harness_sources_import_no_jax():
    for path in glob.glob(os.path.join(harness.HERE, "**", "*.py"), recursive=True):
        if path == os.path.abspath(__file__):
            continue
        text = open(path).read()
        for word in ("import jax", "from jax", "import flax", "from flax",
                     "import paddlerec_tpu\n", "from paddlerec_tpu ", "from paddlerec_tpu."):
            assert word not in text, (path, word)
