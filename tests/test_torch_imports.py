"""Import guard: the port and chip_smoke.py import nothing of JAX, ml_dtypes
or the JAX package, and the port serves and trains (bucketed and on the
tree layout, checkpointing, resuming and rematerialising) with JAX made
unimportable."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_no_forbidden_imports():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{f.relative_to(REPO)}:{line} imports {root}"
           for f in files for line, root in _imported_roots(f) if root in FORBIDDEN]
    assert not bad, bad


def test_port_serves_with_jax_unimportable():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
            sys.modules[name] = None          # any import of them now fails
        import numpy as np, torch
        from repro_torch.configs import get_config
        from repro_torch.launch.api import Request, SamplingParams, make_engine
        from repro_torch.models.model import build_model
        import dataclasses
        cfg = dataclasses.replace(get_config("gpt-smoke", smoke=True), flash_min_len=8)
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        toks, _ = model.generate(params, {"tokens": torch.arange(10)[None] % 256}, 4)
        assert toks.shape == (1, 4)
        eng = make_engine(model, params, mode="closed", max_batch=2,
                          sampling=SamplingParams())
        res, rep = eng.run([Request(tokens=np.arange(9)), Request(tokens=np.arange(3))], 3)
        assert [r.n_generated for r in res] == [3, 3], res
        from repro_torch.launch import train
        hist = train.main(["--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "16",
                           "--batch", "2", "--bucketed", "--fused-kernel",
                           "--flash-min-len", "8", "--log-every", "1"])
        assert len(hist) == 2 and hist[-1]["edq"] > 0, hist
        hist = train.main(["--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "16",
                           "--batch", "2", "--precision", "SR", "--flash-min-len", "8",
                           "--log-every", "1"])          # the tree layout
        assert len(hist) == 2 and hist[-1]["edq"] > 0, hist
        import tempfile
        with tempfile.TemporaryDirectory() as d:     # checkpoints: bf16 through uint16
            flags = ["--smoke", "--device", "cpu", "--seq-len", "16", "--batch", "2",
                     "--bucketed", "--log-every", "1", "--ckpt-dir", d, "--remat", "dots"]
            train.main([*flags, "--steps", "2", "--ckpt-every", "1"])
            hist = train.main([*flags, "--steps", "3", "--resume"])
            assert [h["step"] for h in hist] == [3], hist
        assert not any(m.split(".")[0] in ("jax", "ml_dtypes") for m in sys.modules
                       if sys.modules[m] is not None)
        print("PORT_WITHOUT_JAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    assert "PORT_WITHOUT_JAX_OK" in out.stdout


def test_audit_runs_with_jax_unimportable(tmp_path):
    """The audit (``repro_torch.analysis``, ``launch.precision_audit``)
    traces and audits a cell with JAX made unimportable."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)
        from repro_torch import analysis
        from repro_torch.launch import precision_audit as pa
        cell = pa.run_one("gpt-tiny", "C", "zero", pa.MODES["zero"], "cpu")
        assert cell["ok"] == {{"no_master_copy": True, "all_donations_realized": True}}, cell
        assert cell["n_donated"] == 6 and cell["double_round_chains"] == 0, cell
        assert analysis.lint_paths(repo_root={str(REPO)!r}) == []
        print("AUDIT_WITHOUT_JAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    assert "AUDIT_WITHOUT_JAX_OK" in out.stdout


def test_moe_grid_step_runs_with_jax_unimportable():
    """An MoE grid step (qwen3-moe smoke on the one-rank grid: the expert
    dispatch, the aux loss through the grid's loss) with JAX made
    unimportable equals the plain step."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.core.collage import CollageAdamW
        from repro_torch.data.synthetic import make_batch_fn
        from repro_torch.distributed import sharding as sh
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.models.model import build_model
        from repro_torch.train import grid as grid_lib, train_loop
        cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
        model = build_model(cfg)
        opt = CollageAdamW(1e-3, compute_metrics=True)
        g = mesh_lib.make_mesh(1, 1, device="cpu")
        batch = make_batch_fn(cfg, ShapeConfig("t", 16, 2, "train"), device="cpu")(0)
        s0 = train_loop.init_state(model, opt, 0, device="cpu")
        s1, m1 = train_loop.make_train_step(model, opt)(s0, batch)
        s2, m2 = train_loop.make_train_step(model, opt, grid=g)(grid_lib.shard_state(s0, g), batch)
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(sh.named_leaves(s1.params), sh.named_leaves(s2.params)))
        assert float(m1["aux"]) == float(m2["aux"]) > 0, (m1, m2)
        assert float(m1["loss"]) == float(m2["loss"]), (m1, m2)
        print("MOE_GRID_WITHOUT_JAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    assert "MOE_GRID_WITHOUT_JAX_OK" in out.stdout


def test_grid_runs_with_jax_unimportable():
    """The grid (``launch.mesh``, ``distributed.sharding``, the grid train
    step, the legacy ``pipeline_apply``) with JAX made unimportable: a
    one-rank grid step equals the plain step, the specs come out, the
    grid serves."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.core.collage import CollageAdamW
        from repro_torch.data.synthetic import make_batch_fn
        from repro_torch.distributed import pipeline as pp, sharding as sh
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.models import transformer as tf
        from repro_torch.models.model import build_model, param_dict
        from repro_torch.train import grid as grid_lib, train_loop
        cfg = get_config("granite-3-2b", smoke=True)
        model = build_model(cfg)
        opt = CollageAdamW(1e-3, compute_metrics=True)
        g = mesh_lib.make_mesh(1, 1, device="cpu")
        batch = make_batch_fn(cfg, ShapeConfig("t", 16, 2, "train"), device="cpu")(0)
        s0 = train_loop.init_state(model, opt, 0, device="cpu")
        s1, m1 = train_loop.make_train_step(model, opt)(s0, batch)
        s2, m2 = train_loop.make_train_step(model, opt, grid=g)(grid_lib.shard_state(s0, g), batch)
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(sh.named_leaves(s1.params), sh.named_leaves(s2.params)))
        assert float(m1["loss"]) == float(m2["loss"]), (m1, m2)
        specs = sh.state_shardings(s0, mesh_lib.grid_shape(2, 4))
        assert specs.params["embed"] == sh.P("model", "data"), specs.params["embed"]
        params = model.init(0, device="cpu")
        with torch.no_grad(), tf.activation_sharding(sh.make_activation_sharder(g)):
            toks, _ = model.generate(params, {"tokens": torch.arange(8)[None]}, 3)
        assert toks.shape == (1, 3)
        out = pp.pipeline_apply(lambda p, h: torch.tanh(h @ p["w"][0]),
                                pp.split_stages({"w": torch.eye(4)[None].repeat(2, 1, 1)}, 2),
                                torch.ones(3, 2, 4))
        assert out.shape == (3, 2, 4)
        print("GRID_WITHOUT_JAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    assert "GRID_WITHOUT_JAX_OK" in out.stdout
