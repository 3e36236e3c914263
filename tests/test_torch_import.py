"""``repro_torch`` stands alone: it never imports JAX or the JAX package,
and its entry points never carry on on the CPU unless asked to."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
SCANNED = PORT_FILES + ["chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("rel", SCANNED)
def test_no_jax_or_reference_imports(rel):
    """An AST scan of every module of the port and of chip_smoke.py: no
    ``import jax`` and nothing of ``repro``."""
    for name in _imported_modules(ROOT / rel):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{rel} imports {name}"


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys\n"
            "import repro_torch.core.apps, repro_torch.convert\n"
            "import repro_torch.core.spmm\n"
            "import repro_torch.kernels.unroll_spmv.ops\n"
            "import repro_torch.kernels.segment_reduce.ops\n"
            "import repro_torch.kernels.gather_vload.ops\n"
            "import repro_torch.kernels.moe_dispatch.ops\n"
            "import repro_torch.sparse.generators\n"
            "import repro_torch.tune, repro_torch.tune.search\n"
            "import repro_torch.tune.calibrate\n"
            "import repro_torch.core.planio, repro_torch.obs.profile\n"
            "import repro_torch.serve.query, repro_torch.testing.faults\n"
            "import repro_torch.launch.serve_queries\n"
            "import repro_torch.launch.mesh, repro_torch.launch.sharding\n"
            "import repro_torch.configs, repro_torch.models.lm\n"
            "import repro_torch.serve.engine, repro_torch.launch.serve\n"
            "import repro_torch.optim.adamw, repro_torch.optim.compress\n"
            "import repro_torch.checkpoint.checkpoint\n"
            "import repro_torch.data.pipeline, repro_torch.train.loop\n"
            "import repro_torch.launch.train\n"
            "import repro_torch.launch.dryrun\n"
            "import repro_torch.launch.step_analysis\n"
            "for a in repro_torch.configs.ARCHS:\n"
            "    repro_torch.configs.get_config(a)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists, so the default device is usable")


def _coo():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 10, 30), rng.integers(0, 10, 30),
            rng.standard_normal(30).astype(np.float32), (10, 10))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_default_device_raises_without_cuda(backend):
    """Without ``device=`` the entry points ask for CUDA; with no CUDA
    device they raise instead of running on the CPU."""
    _no_cuda()
    from repro_torch.core.apps import SpMV
    from repro_torch.core.spmm import SpMM
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpMV.from_coo(*_coo(), backend=backend)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpMM.from_coo(*_coo(), backend=backend, reduce="min")
    rows, cols, vals, shape = _coo()
    order = np.lexsort((cols, rows))
    indptr = np.r_[0, np.cumsum(np.bincount(rows, minlength=shape[0]))]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpMV.from_csr(indptr, cols[order], vals[order], shape,
                      backend=backend)


def test_sharded_default_device_raises_without_cuda():
    """``shards=`` asks for CUDA devices too: a mesh of cards is never
    quietly built on the CPU, simulated or not."""
    _no_cuda()
    from repro_torch.core.apps import SpMV
    from repro_torch.launch.mesh import make_shard_mesh
    with pytest.raises(ValueError, match="only 0 cuda device"):
        make_shard_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_shard_mesh(2, simulate=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpMV.from_coo(*_coo(), shards=2, simulate_mesh=True)


def test_executor_default_device_raises_without_cuda():
    _no_cuda()
    from repro_torch.core import engine as eng
    from repro_torch.core.plan import CostModel, build_plan
    from repro_torch.core.seed import spmv_seed
    rows, cols, vals, shape = _coo()
    plan = build_plan(spmv_seed(), {"row": rows, "col": cols}, *shape,
                      CostModel(lane_width=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.make_executor(plan, {"value": vals}, backend="cuda")


@pytest.mark.parametrize("app", ["bfs", "sssp", "spmv"])
def test_launcher_default_device_raises_without_cuda(app, capsys):
    """``python -m repro_torch.launch.serve_queries`` asks for CUDA unless
    ``--device cpu`` is given, and raises before it builds anything."""
    _no_cuda()
    from repro_torch.launch import serve_queries
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_queries.main(["--app", app, "--nodes", "64", "--requests",
                            "4"])
    assert "[serve]" not in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-235b-a22b"])
def test_lm_launcher_default_device_raises_without_cuda(arch, capsys):
    """``python -m repro_torch.launch.serve`` asks for CUDA unless
    ``--device cpu`` is given, and raises before it builds a model; so
    does ``init_model``."""
    _no_cuda()
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--steps", "2"])
    assert "[serve]" not in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_model(get_config(arch).reduced())


def test_training_default_device_raises_without_cuda(tmp_path, capsys):
    """``Trainer``, its data iterator and ``python -m
    repro_torch.launch.train`` ask for CUDA unless given the CPU, and
    raise before they build a model."""
    _no_cuda()
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataIterator
    from repro_torch.launch import train
    from repro_torch.train.loop import TrainConfig, Trainer
    cfg = get_config("granite-3-2b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainConfig(steps=1, ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataIterator(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert "[train]" not in capsys.readouterr().out
    assert not list(tmp_path.iterdir())


def test_kernel_wrappers_never_take_the_plain_path_on_other_devices():
    """The plain version runs only for CPU tensors; anything else launches
    the kernel or raises."""
    from repro_torch.kernels.unroll_spmv import kernel as K
    seg = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no stage-A kernel"):
        K.window_stage_a(seg, [torch.ones(8, device="meta")], [], seg, seg,
                         seg, op=0, stream=False, reduce="add")
    with pytest.raises(ValueError, match="no stage-A kernel"):
        K.dense_slice_stage_a(seg[0], [torch.ones(8, device="meta")], [],
                              None, seg, op=0, reduce="add")


def test_standalone_wrappers_never_take_the_plain_path_on_other_devices():
    from repro_torch.kernels.gather_vload.ops import gather_vload_op
    from repro_torch.kernels.moe_dispatch.ops import row_gather_op
    from repro_torch.kernels.segment_reduce.ops import segment_reduce_op
    idx = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    x = torch.ones((2, 8, 3), device="meta")
    with pytest.raises(ValueError, match="no segment_reduce kernel"):
        segment_reduce_op(x, idx, 1)
    with pytest.raises(ValueError, match="no gather_vload kernel"):
        gather_vload_op(x, idx[:, :1], idx, idx, ls=1)
    with pytest.raises(ValueError, match="no row_gather kernel"):
        row_gather_op(x[0], idx[0])


def _run_smoke(script: Path, cwd: Path, fake_card: bool):
    """Run ``chip_smoke.py`` as ``__main__``; ``fake_card`` makes
    ``torch.cuda.is_available()`` report a card so the later checks run."""
    pre = ("import torch; torch.cuda.is_available = lambda: True; "
           if fake_card else "")
    code = (f"{pre}import runpy; runpy.run_path({str(script)!r}, "
            "run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    """No CUDA: non-zero exit and no result line."""
    _no_cuda()
    proc = _run_smoke(ROOT / "chip_smoke.py", ROOT, fake_card=False)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "is_available" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it fails before doing any work, even where a card exists."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = _run_smoke(alone, tmp_path, fake_card=True)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "repro_torch" in proc.stderr
