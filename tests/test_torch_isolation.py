"""dsjax_torch never imports jax, and never runs on the CPU unasked."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORTS = ("dsjax_torch", "dsjax_torch.server", "dsjax_torch.inference",
           "dsjax_torch.model.ds2", "dsjax_torch.model.convert", "dsjax_torch.model.ctc",
           "dsjax_torch.ops.lstm", "dsjax_torch.decode.greedy", "dsjax_torch.audio.features",
           "dsjax_torch.audio.io", "dsjax_torch.config", "dsjax_torch.labels",
           "dsjax_torch.workflows", "dsjax_torch.train.loop", "dsjax_torch.train.state",
           "dsjax_torch.train.checkpoint", "dsjax_torch.train.metrics",
           "dsjax_torch.train.logging", "dsjax_torch.data.dataset", "dsjax_torch.data.loader",
           "dsjax_torch.data.sampler", "dsjax_torch.data.manifest", "dsjax_torch.ops.topk",
           "dsjax_torch.ops.beam", "dsjax_torch.decode.beam_device", "dsjax_torch.evaluate",
           "dsjax_torch.transcribe", "dsjax_torch.ops.gru", "dsjax_torch.ops.mm_chain",
           "dsjax_torch.audio.native", "dsjax_torch.decode.lm", "dsjax_torch.decode.beam",
           "dsjax_torch.decode.lm_device", "dsjax_torch.decode.native_beam",
           "dsjax_torch.search_lm_params", "dsjax_torch.select_lm_params",
           "dsjax_torch.build_lm_binary", "dsjax_torch.audio.augment",
           "dsjax_torch.noise_inject", "dsjax_torch.parallel",
           "dsjax_torch.parallel.distributed", "dsjax_torch.parallel.multihost",
           "dsjax_torch.parallel.mesh", "dsjax_torch.datasets.common",
           "dsjax_torch.datasets.an4", "dsjax_torch.datasets.librispeech",
           "dsjax_torch.datasets.ted", "dsjax_torch.datasets.common_voice",
           "dsjax_torch.datasets.voxforge", "dsjax_torch.data.merge_manifests",
           "dsjax_torch.data.verify_manifest")


def _imports(path):
    """(module name, inside a function?) for every import statement of a file."""
    tree = ast.parse(open(path).read())
    found = []

    def visit(node, in_def):
        for child in ast.iter_child_nodes(node):
            inner = in_def or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
            if isinstance(child, ast.Import):
                found.extend((a.name, inner) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                found.append((child.module, inner))
            visit(child, inner)

    visit(tree, False)
    return found


@pytest.mark.parametrize("path", sorted(
    [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tools", "torch_profile_serving.py"),
     os.path.join(ROOT, "tools", "torch_profile_train.py"),
     os.path.join(ROOT, "tools", "torch_profile_eval.py"),
     os.path.join(ROOT, "tools", "torch_lstm_microbench.py"),
     os.path.join(ROOT, "tools", "torch_kernel_probe.py"),
     os.path.join(ROOT, "tools", "torch_data_parallel.py"),
     os.path.join(ROOT, "tests", "synthetic_manifest.py"),
     os.path.join(ROOT, "tests", "synthetic_lm.py"),
     os.path.join(ROOT, "tests", "synthetic_corpora.py"),
     os.path.join(ROOT, "tests", "golden_gru.py"),
     os.path.join(ROOT, "tests", "dsjax_layout.py"),
     os.path.join(ROOT, "tests", "torch_ddp_worker.py")]
    + glob.glob(os.path.join(ROOT, "dsjax_torch", "**", "*.py"), recursive=True)),
    ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_the_jax_package(path):
    """The port and its card-side scripts import nothing of jax or dsjax,
    not even dsjax's native decoders (the port builds its own copies)."""
    for name, _ in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "orbax", "dsjax"), name


def test_port_imports_no_jax(tmp_path):
    """With jax and the JAX package made unimportable, every port module
    imports, the port's download_an4 prepares a local AN4 archive into its
    three manifests, and none of jax's companions or triton got loaded."""
    from tests.synthetic_corpora import write_an4_archive

    write_an4_archive(str(tmp_path / "an4.tar.gz"), seed=0, n_train=2, n_val=1, n_test=1)
    code = "\n".join([
        "import importlib, sys",
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'dsjax'):",
        "    sys.modules[name] = None",
        f"for mod in {IMPORTS!r}:",
        "    importlib.import_module(mod)",
        "import dsjax_torch",
        "dsjax_torch.DeepSpeech2, dsjax_torch.load_model, dsjax_torch.lstm_scan",
        "dsjax_torch.gru_scan",
        "dsjax_torch.Trainer, dsjax_torch.TrainConfig",
        "import dsjax_torch.config as c, dsjax_torch.train.checkpoint as k, tests.dsjax_layout",
        "k.from_dsjax_state, k.refuse_dsjax_layout, c.to_dict, c.from_dict, c.print_help",
        "import os; os.chdir(os.path.join(os.getcwd(), 'tests'))",
        "assert c.compose(c.TrainConfig, ['+configs=an4']).data.batch_size == 8",
        "assert c.find_overlay('an4').endswith(os.path.join('dsjax_torch', 'configs', 'an4.yaml'))",
        "import contextlib, io, json, dsjax_torch.datasets.an4 as an4",
        f"os.chdir({str(tmp_path)!r})",
        "with contextlib.redirect_stdout(io.StringIO()):",
        "    an4.download_an4('an4_dataset', 'data', 1, 15)",
        "sizes = [len(json.load(open(f'data/an4_{s}_manifest.json'))['samples'])",
        "         for s in ('train', 'val', 'test')]",
        "assert sizes == [2, 1, 2], sizes",
        "loaded = [m for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax')",
        "          if sys.modules.get(m) is not None]",
        "assert not loaded, loaded",
        "assert 'triton' not in sys.modules",
        "assert not any(m.startswith(('jax.', 'flax.')) for m in sys.modules)",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_cuda_means_no_silent_cpu(monkeypatch, tmp_path):
    from dsjax_torch.labels import DEFAULT_LABELS
    from dsjax_torch.config import BiDirectionalConfig, SpectConfig
    from dsjax_torch.inference import ModelBundle, load_model
    from dsjax_torch.model.convert import save_checkpoint
    from dsjax_torch.model.ds2 import DeepSpeech2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = BiDirectionalConfig(hidden_size=16, hidden_layers=1)
    model = DeepSpeech2(len(DEFAULT_LABELS), SpectConfig(), cfg,
                        generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "m.pt")
    save_checkpoint(path, model.state_dict(), cfg, SpectConfig(), DEFAULT_LABELS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelBundle(model, list(DEFAULT_LABELS), SpectConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(path)
    assert load_model(path, device="cpu").device == torch.device("cpu")
