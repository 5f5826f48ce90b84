"""The port stands alone: importing every module of ``fedml_tpu_torch``
(in a fresh interpreter) loads neither JAX, the JAX package nor pandas
(the card's machine has none), no port
source, ``chip_smoke.py`` or the card's test file names them in an
import, and the entry points refuse to run on the CPU unless the caller
asks for it."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import ast
import os
import subprocess
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "fedml_tpu_torch")


def _modules():
    out = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'pandas')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax', 'optax',\n"
        "                              'pandas.'))\n"
        "             or m == 'fedml_tpu' or m.startswith('fedml_tpu.'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 15


def test_no_source_imports_jax_or_the_jax_package():
    files = [os.path.join(ROOT, m.replace(".", os.sep) + ".py")
             for m in _modules()]
    files = [f if os.path.exists(f) else f[:-3] + os.sep + "__init__.py"
             for f in files] + [os.path.join(ROOT, "chip_smoke.py"),
                                os.path.join(ROOT, "tests",
                                             "test_torch_cuda.py")]
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read(), f)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax",
                                   "fedml_tpu"), f"{f} imports {n}"


def test_the_compression_package_needs_no_jax_and_no_ml_dtypes():
    """``fedml_tpu_torch/compression`` loads neither JAX, the JAX package
    nor ``ml_dtypes`` (its codec frames bf16 from raw words), and no
    source of it names ``ml_dtypes`` in an import."""
    code = (
        "import importlib, sys\n"
        "for m in ('codec', 'wire', 'compressors', 'integration'):\n"
        "    importlib.import_module('fedml_tpu_torch.compression.' + m)\n"
        "import fedml_tpu_torch.compression as c\n"
        "c.get_compressor('topk:0.1'); c.ResidualStore\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes')\n"
        "             or m.startswith(('jax.', 'ml_dtypes.', 'fedml_tpu.'))\n"
        "             or m == 'fedml_tpu')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    pkg = os.path.join(PKG, "compression")
    for f in sorted(os.listdir(pkg)):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(pkg, f)) as fh:
            tree = ast.parse(fh.read(), f)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] in ("ml_dtypes", "jax",
                                               "fedml_tpu")
                           for n in names), f"{f} imports {names}"


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.specs import make_classification_spec
    from fedml_tpu_torch.data.synthetic import load_synthetic_images
    from fedml_tpu_torch.models import resnet56
    from fedml_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    dataset = load_synthetic_images(client_num=4, n_train=80, n_test=16,
                                    image_size=8, seed=0)
    args = types.SimpleNamespace(
        client_num_in_total=4, client_num_per_round=4, comm_round=1,
        epochs=1, batch_size=16, lr=0.01, wave_mode=3, client_chunk=2)
    spec = make_classification_spec(resnet56(), lane_lowering="pallas")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedAvgAPI(dataset, spec, args)


def test_serverless_split_vertical_and_secure_entry_points_need_a_gpu(
        monkeypatch):
    """The gossip, online, split, vertical and secure APIs and their four
    mains raise without a card unless asked for the CPU."""
    import numpy as np

    from fedml_tpu_torch.algorithms import (DecentralizedFedAPI,
                                            DecentralizedOnlineAPI,
                                            SplitNNAPI, TurboAggregateAPI,
                                            VerticalFLAPI)
    from fedml_tpu_torch.algorithms.specs import make_classification_spec
    from fedml_tpu_torch.data import uci
    from fedml_tpu_torch.data.synthetic import load_synthetic_federated
    from fedml_tpu_torch.experiments import (main_decentralized,
                                             main_splitnn,
                                             main_turboaggregate, main_vfl)
    from fedml_tpu_torch.experiments.main_splitnn import split_pair
    from fedml_tpu_torch.models.linear import LocalModel, LogisticRegression

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = load_synthetic_federated(client_num=2, n_train=40, n_test=8,
                                  seed=0)
    args = types.SimpleNamespace(
        client_num_in_total=2, client_num_per_round=2, comm_round=1,
        epochs=1, batch_size=8, lr=0.1, seed=0)
    spec = make_classification_spec(LogisticRegression(60, 10))
    x = np.zeros((4, 3), np.float32)
    builds = [
        lambda d: DecentralizedFedAPI(ds, spec, args, device=d),
        lambda d: DecentralizedOnlineAPI(
            uci.load_synthetic_stream(client_num=2, T=4), args, device=d),
        lambda d: SplitNNAPI(ds, *split_pair("dense", (60,), 10), args,
                             device=d),
        lambda d: VerticalFLAPI([LocalModel(3, output_dim=1)], [x],
                                np.zeros(4), args, device=d),
        lambda d: TurboAggregateAPI(ds, spec, args, device=d),
    ]
    for build in builds:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(None)
        assert build("cpu").device == torch.device("cpu")
    tiny = ["--comm_round", "1", "--client_num_in_total", "2"]
    for main, argv in ((main_decentralized, []),
                       (main_decentralized, ["--online", "1"]),
                       (main_splitnn, ["--dataset", "synthetic",
                                       "--cut", "dense"]),
                       (main_turboaggregate, []),
                       (main_vfl, ["--dataset", "synthetic_vertical"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main.main(argv + tiny)


def test_segmentation_nas_and_gkt_entry_points_need_a_gpu(monkeypatch):
    """FedSeg, FedNAS and FedGKT's APIs and their three mains raise
    without a card unless asked for the CPU."""
    from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI
    from fedml_tpu_torch.algorithms.fednas import FedNASAPI
    from fedml_tpu_torch.algorithms.fedseg import FedSegAPI
    from fedml_tpu_torch.algorithms.specs import make_segmentation_spec
    from fedml_tpu_torch.data.synthetic import (load_synthetic_images,
                                                load_synthetic_segmentation)
    from fedml_tpu_torch.experiments import (main_fedgkt, main_fednas,
                                             main_fedseg)
    from fedml_tpu_torch.models import darts, deeplab, gkt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seg = load_synthetic_segmentation(client_num=2, n_train=8, n_test=4,
                                      image_size=8)
    img = load_synthetic_images(client_num=2, n_train=16, n_test=4,
                                image_size=8, partition="homo", seed=0)
    args = types.SimpleNamespace(
        client_num_in_total=2, client_num_per_round=2, comm_round=1,
        epochs=1, batch_size=4, lr=0.1, seed=0, lr_scheduler="poly")
    builds = [
        lambda d: FedSegAPI(seg, make_segmentation_spec(
            deeplab.DeepLab(num_classes=4, backbone="mobilenet")), args,
            device=d),
        lambda d: FedNASAPI(img, args, model=darts.DARTSNetwork(
            C=2, layers=1, num_classes=10, steps=1), device=d),
        lambda d: FedGKTAPI(img, gkt.resnet5_56(), gkt.GKTServerResNet(n=1),
                            args, device=d),
    ]
    for build in builds:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(None)
        assert build("cpu").device == torch.device("cpu")
    tiny = ["--comm_round", "1", "--client_num_in_total", "2",
            "--n_train", "40", "--image_size", "8"]
    for main, argv in ((main_fedseg, ["--dataset",
                                      "synthetic_segmentation"]),
                       (main_fednas, ["--dataset", "synthetic_images"]),
                       (main_fedgkt, ["--dataset", "synthetic_images"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main.main(argv + tiny)


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result(tmp_path):
    """The on-card smoke test exits non-zero, with no ``ok`` line, both
    here (no GPU) and alone in a directory without the port."""
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text(open(os.path.join(ROOT,
                                                "chip_smoke.py")).read())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
