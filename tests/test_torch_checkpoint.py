"""The port reads the reference's Lightning ``.ckpt`` files (CPU).

Such a file keeps omegaconf objects among its hyper-parameters. Here they
are stand-ins: instances of classes of a throwaway module, written with
torch.save, whose module is then taken off sys.modules and the path, so
that neither loader can import it. dsjax (``torch_import``, whose
unpickler stubs what it cannot import) and the port
(``dsjax_torch.inference.load_model``, whose unpickler resolves only what a
tensor state needs) must load the same weights, labels and spect_cfg; a
pickle that names an importable function must load without the port
importing or calling it.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from dsjax.model.torch_import import import_checkpoint, load_torch_state_dict
from dsjax_torch.config import SpectConfig
from dsjax_torch.inference import load_model
from dsjax_torch.model import convert
from tests.test_torch_model import reference_state

STUBS = '''
import enum


class DictConfig:
    def __init__(self, content):
        self._content = content
        self._metadata = {"ref_type": "stand-in"}


class ListConfig(DictConfig):
    pass


class AnyNode:
    def __init__(self, value):
        self._val = value
        self._metadata = {"optional": True}


class SpectrogramWindow(enum.Enum):
    hamming = "hamming"
    hann = "hann"
'''

LABELS = list("_'ABCDEFGHIJKLMNOPQRSTUVWXYZ ")[::-1]
# not the defaults, with the defaults' 320-sample window (161 bins), which
# the weights' first recurrent layer is sized for
SPECT = {"sample_rate": 8000, "window_size": 0.04, "window_stride": 0.02, "window": "hamming"}


def write_module(tmp_path, name, source):
    """Import a module written into tmp_path, then make it unimportable
    again except by the path (returned, for the caller to drop)."""
    folder = str(tmp_path / f"mod_{name}")
    os.makedirs(folder)
    with open(os.path.join(folder, f"{name}.py"), "w") as f:
        f.write(source)
    sys.path.insert(0, folder)
    __import__(name)
    return folder


def forget(name, folder):
    sys.modules.pop(name, None)
    if folder in sys.path:
        sys.path.remove(folder)


@pytest.mark.parametrize("labels_as", ["list", "listconfig"])
def test_reference_ckpt_with_omegaconf_stand_ins_loads_as_in_dsjax(tmp_path, labels_as):
    state = reference_state(seed=14, hidden=32, layers=2)
    folder = write_module(tmp_path, "ckpt_stand_ins", STUBS)
    mod = sys.modules["ckpt_stand_ins"]
    try:
        labels = LABELS if labels_as == "list" else mod.ListConfig(list(LABELS))
        path = str(tmp_path / "reference.ckpt")
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()},
                    "hyper_parameters": {"labels": labels, "spect_cfg": mod.DictConfig(SPECT),
                                         "model_cfg": mod.DictConfig({"hidden_size": 32})},
                    "epoch": 3}, path)
    finally:
        forget("ckpt_stand_ins", folder)

    with pytest.raises(pickle.UnpicklingError):
        torch.load(path, map_location="cpu", weights_only=True)
    imported = import_checkpoint(path)
    _, hparams = load_torch_state_dict(path)
    bundle = load_model(path, device="cpu")
    assert "ckpt_stand_ins" not in sys.modules

    want = convert.from_dsjax_variables({"params": imported["params"],
                                         "batch_stats": imported["batch_stats"]})
    got = bundle.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    # dsjax takes labels only as a plain list and leaves a ListConfig's in
    # its plainified hyper-parameters
    want_labels = (imported["labels"] if labels_as == "list"
                   else hparams["labels"]["_content"])
    assert bundle.labels == want_labels == LABELS
    jspect = imported["spect_cfg"]
    assert (bundle.spect_cfg.sample_rate, bundle.spect_cfg.window_size,
            bundle.spect_cfg.window_stride) == (jspect.sample_rate, jspect.window_size,
                                                jspect.window_stride) == (8000, 0.04, 0.02)
    assert bundle.spect_cfg.window.value == jspect.window.value == "hamming"


def test_omegaconf_value_nodes_and_enums_read_through_stubs(tmp_path):
    """omegaconf keeps a DictConfig's values as nodes (their value in
    ``_val``) and an enum field as the enum, which pickles as its class
    called with its value: the port reads through both."""
    state = reference_state(seed=17, hidden=16, layers=1)
    folder = write_module(tmp_path, "ckpt_stand_ins", STUBS)
    mod = sys.modules["ckpt_stand_ins"]
    try:
        spect = mod.DictConfig({"sample_rate": mod.AnyNode(8000),
                                "window_size": mod.AnyNode(0.04),
                                "window_stride": mod.AnyNode(0.02),
                                "window": mod.AnyNode(mod.SpectrogramWindow.hann)})
        labels = mod.ListConfig([mod.AnyNode(c) for c in LABELS])
        path = str(tmp_path / "nodes.ckpt")
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()},
                    "hyper_parameters": mod.DictConfig({"labels": labels,
                                                        "spect_cfg": spect})}, path)
    finally:
        forget("ckpt_stand_ins", folder)
    bundle = load_model(path, device="cpu")
    assert bundle.labels == LABELS
    assert (bundle.spect_cfg.sample_rate, bundle.spect_cfg.window_size,
            bundle.spect_cfg.window_stride, bundle.spect_cfg.window.value) == \
        (8000, 0.04, 0.02, "hann")


MARKER = '''
import os

open(os.environ["CKPT_MARKER_DIR"] + "/imported", "w").close()


def mark(name):
    open(os.environ["CKPT_MARKER_DIR"] + "/" + name, "w").close()
    return name


class CallsMark:
    def __reduce__(self):
        return (mark, ("called",))


class CallsSystem:
    def __reduce__(self):
        return (os.system, ("touch " + os.environ["CKPT_MARKER_DIR"] + "/system",))
'''


def test_loader_neither_imports_nor_calls_what_the_pickle_names(tmp_path, monkeypatch):
    marks = tmp_path / "marks"
    marks.mkdir()
    monkeypatch.setenv("CKPT_MARKER_DIR", str(marks))
    folder = write_module(tmp_path, "ckpt_marker", MARKER)
    mod = sys.modules["ckpt_marker"]
    (marks / "imported").unlink()
    state = reference_state(seed=15, hidden=16, layers=1)
    path = str(tmp_path / "hostile.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()},
                "hyper_parameters": {"labels": LABELS, "callback": mod.CallsMark(),
                                     "hook": mod.CallsSystem()}}, path)
    sys.modules.pop("ckpt_marker")
    try:
        # the module stays importable: a loader that resolved it would
        # import it, and then call mark and os.system
        bundle = load_model(path, device="cpu")
        ckpt = convert.load_checkpoint(path)
    finally:
        forget("ckpt_marker", folder)
    assert "ckpt_marker" not in sys.modules
    assert sorted(os.listdir(marks)) == []
    hp = ckpt["hyper_parameters"]
    assert isinstance(hp["callback"], convert._Stub) and isinstance(hp["hook"], convert._Stub)
    assert type(hp["callback"]).__module__ == "ckpt_marker"
    assert bundle.labels == LABELS
    want = convert.from_reference_state_dict(state)
    for k, v in bundle.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def test_port_checkpoints_keep_every_value_through_the_restricted_loader(tmp_path):
    """What save_checkpoint and the trainer write (tensors, an optimizer's
    state, plain data) comes back equal, and the hyper-parameters as saved."""
    state = reference_state(seed=16, hidden=16, layers=1)
    port = convert.from_reference_state_dict(state)
    cfg, _ = convert.infer_architecture(state)
    opt = torch.optim.AdamW([torch.nn.Parameter(torch.ones(3))], lr=1e-3)
    opt.param_groups[0]["params"][0].grad = torch.full((3,), 0.5)
    opt.step()
    extra = {"optimizer": opt.state_dict(), "step": 7, "metrics": {"wer": 0.25},
             "extra": {"start_index": 4}}
    path = str(tmp_path / "port.pt")
    convert.save_checkpoint(path, port, cfg, SpectConfig(), LABELS, extra=extra)
    got = convert.load_checkpoint(path)
    want = torch.load(path, map_location="cpu", weights_only=True)

    def same(a, b):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        elif isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a == b

    same(got, want)
    assert convert.plain_hparams(got["hyper_parameters"])["spect_cfg"]["window"] == "hamming"
    assert np.isclose(got["metrics"]["wer"], 0.25)
