"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Module names are compared by their
whole top-level name: ``dsjax_torch`` begins with ``dsjax`` but is not it."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

HARNESS = """
import sys
sys.path.insert(0, {root!r})
import portbench.run as run, portbench.harness, portbench.readings, portbench.faults
import portbench.drivers.train, portbench.drivers.eval, portbench.drivers.ddp_train
import portbench.ranks, portbench.kernels
portbench.kernels.found()
portbench.kernels.counters()
# what the drivers import of the port when they run
import dsjax_torch.train.loop, dsjax_torch.inference, dsjax_torch.data.loader
import dsjax_torch.decode.beam_device, dsjax_torch.model.convert, dsjax_torch.train.metrics
import dsjax_torch.parallel.distributed
for f in sorted((run.ROOT / "portbench" / "metrics").glob("*.py")):
    run.load_module(f, "m_" + f.stem.replace(".", "_"))
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import portbench.reference.ds2, portbench.reference.train, portbench.reference.beam
import portbench.weights, portbench.traffic, portbench.counts, portbench.check
import portbench.reference.cells as cells, portbench.kernels
cells.find("lstm"), cells.find("gru"), portbench.kernels.found()
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_names(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.strip().split(","))


def test_harness_process_loads_no_jax():
    names = top_level_names(HARNESS)
    assert "dsjax_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "dsjax"}


def test_reference_loads_nothing_of_the_program():
    names = top_level_names(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "dsjax", "dsjax_torch"}


@pytest.mark.parametrize("loaded, found", [
    ("dsjax_torch.ops", []), ("dsjaxish", []), ("jaxtyping", []),
    ("dsjax.model", ["dsjax"]), ("jax.numpy", ["jax"]), ("flax", ["flax"]),
])
def test_forbidden_names_compare_whole(monkeypatch, loaded, found):
    from portbench import run

    monkeypatch.setattr(sys, "modules", {loaded: object(), "os": sys.modules["os"]})
    assert run.forbidden_modules() == found
