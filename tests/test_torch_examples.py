"""The port's last three example scripts against the JAX package's (CPU):
``examples/torch_quickstart.py``, ``torch_train_e2e.py`` and
``torch_serve_batched.py`` with ``--device cpu``, at their smallest
arguments, each beside its counterpart in this process.

Both sides start from the same weights: the JAX init at the run's seed,
bridged into the port (``models/bridge.params_from_jax``), and read the
same synthetic corpus.  Each prints its counterpart's lines, in order and
with the same keys and steps; the first training step's loss, a function
of those weights and that batch, agrees within 1e-3 relative.  Later
losses are not compared: at these examples' learning rate the runs are
chaotic, and two CPU runs of examples/quickstart.py itself ended 1.4 %
apart (44.633 -> 9.560 and -> 9.698).  The served sample, greedy tokens
of the same weights, is equal.
"""
import contextlib
import io
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import quickstart  # noqa: E402
import serve_batched  # noqa: E402
import torch_quickstart  # noqa: E402
import torch_serve_batched  # noqa: E402
import torch_train_e2e  # noqa: E402
import train_e2e  # noqa: E402
from repro.runtime import serve as jax_serve  # noqa: E402
from repro.runtime import train as jax_train  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.runtime import serve as serve_rt  # noqa: E402
from repro_torch.runtime import train as train_rt  # noqa: E402

REL = 1e-3
NUM = re.compile(r"-?\d+\.?\d*(?:e[-+]?\d+)?")


def _run(main, *argv) -> list[str]:
    out = io.StringIO()
    old = sys.argv
    sys.argv = [main.__module__, *argv]
    try:
        with contextlib.redirect_stdout(out):
            main()
    finally:
        sys.argv = old
    return out.getvalue().splitlines()


@pytest.fixture
def shared_weights(monkeypatch):
    """The JAX Trainer's and Server's initial weights, captured as they are
    drawn, and loaded into the port's Trainer and Server in their place."""
    drawn = {}
    init_state = jax_train.Trainer.init_state

    def capture(self):
        params, opt, start = init_state(self)
        drawn["params"] = jax.tree.map(np.asarray, params)
        return params, opt, start

    monkeypatch.setattr(jax_train.Trainer, "init_state", capture)
    port_init = train_rt.Trainer.init_state

    def load(self):
        params, opt, start = port_init(self)
        self.model.load_params(params_from_jax(drawn["params"]))
        return params, opt, start

    monkeypatch.setattr(train_rt.Trainer, "init_state", load)
    server_init = jax_serve.Server.__init__

    def capture_server(self, cfg, params=None):
        server_init(self, cfg, params)
        drawn["params"] = jax.tree.map(np.asarray, self.params)

    monkeypatch.setattr(jax_serve.Server, "__init__", capture_server)
    port_server = serve_rt.Server.__init__

    def load_server(self, cfg, params=None):
        port_server(self, cfg, params_from_jax(drawn["params"]))

    monkeypatch.setattr(serve_rt.Server, "__init__", load_server)
    return drawn


def _keys(line: str) -> str:
    """A line with its numbers blanked and its padding collapsed: what
    must match word for word."""
    return " ".join(NUM.sub("#", line).split())


def _first_loss(lines: list[str], pattern: str) -> float:
    return float(re.search(pattern, "\n".join(lines)).group(1))


def test_quickstart(shared_weights):
    want = _run(quickstart.main)
    got = _run(torch_quickstart.main, "--device", "cpu")
    assert [_keys(x) for x in got[:3]] == [_keys(x) for x in want[:3]]
    # the timeline: its header, the CPU and DEV rows and the legend
    assert [x.split()[0] for x in got[3:]] == [x.split()[0]
                                               for x in want[3:]]
    assert got[3].split()[:4] == want[3].split()[:4]     # rank 0 step N
    first = r"loss (\S+) ->"
    assert _first_loss(got, first) == pytest.approx(_first_loss(want, first),
                                                    rel=REL)


def test_train_e2e(shared_weights):
    args = ("--steps", "12", "--batch", "2", "--seq", "32")
    want = _run(train_e2e.main, *args)
    got = _run(torch_train_e2e.main, *args, "--device", "cpu")
    assert [_keys(x) for x in got] == [_keys(x) for x in want]
    steps = [re.search(r"step\s+(\d+)", x).group(1)
             for x in got if "loss" in x and "step" in x]
    assert steps == [re.search(r"step\s+(\d+)", x).group(1)
                     for x in want if "loss" in x and "step" in x]
    first = r"step\s+0\s+loss (\S+)"
    assert _first_loss(got, first) == pytest.approx(_first_loss(want, first),
                                                    rel=REL)


def test_train_e2e_restarts_like_the_reference(shared_weights):
    """With ``--inject-fault`` both crash at the middle step and their
    supervisors restart once from the latest checkpoint."""
    args = ("--steps", "12", "--batch", "2", "--seq", "32", "--inject-fault")
    want = _run(train_e2e.main, *args)
    got = _run(torch_train_e2e.main, *args, "--device", "cpu")
    assert [_keys(x) for x in got] == [_keys(x) for x in want]
    assert any(x.startswith("supervisor: 1 restart(s)") for x in got)


def test_serve_batched(shared_weights):
    args = ("--arch", "llama3.2-1b", "--batch", "2", "--prompt-len", "8",
            "--new-tokens", "4")
    want = _run(serve_batched.main, *args)
    got = _run(torch_serve_batched.main, *args, "--device", "cpu")
    assert [_keys(x) for x in got] == [_keys(x) for x in want]
    assert got[0].split()[:3] == want[0].split()[:3]      # 2x4 tokens
    assert got[1] == want[1]          # the sample: the same greedy tokens
    assert got[-1].split()[:2] == want[-1].split()[:2]
