"""The port stands alone: ``marl_dmfb_tpu_torch`` (its tracing module
``utils/tracing.py`` too), ``chip_smoke.py`` and the card's tools
(``tools/profile_torch_mesh.py``, ``tools/time_dmfb_step.py``,
``tools/repeat_torch_benches.py``, ``tools/time_to_quality_torch.py``,
``tools/time_to_quality_seeds.py``, ``tools/degrade_sweeps_torch.py``,
``tools/time_after_profiler.py``, ``tools/ring_size_torch.py``)
import nothing of JAX, its libraries, YAML, matplotlib or the JAX package
(the GPU machine has none of them), nor the JAX-side tools of the port:
``tools/export_flax_npz.py``, whose ``.npz`` files they read with numpy,
and ``tools/degrade_replay_jax.py`` and ``tools/degrade_seeds_jax.py``,
which run the JAX package's sweeps on the CPU;
and the entry point runs on the card unless told otherwise, raising where
there is none."""

import ast
import pathlib
import re

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "yaml",
             "matplotlib", "marl_dmfb_tpu"}
PORT_FILES = sorted((ROOT / "marl_dmfb_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_mesh.py",
    ROOT / "tools" / "time_dmfb_step.py",
    ROOT / "tools" / "repeat_torch_benches.py",
    ROOT / "tools" / "time_to_quality_torch.py",
    ROOT / "tools" / "time_to_quality_seeds.py",
    ROOT / "tools" / "degrade_sweeps_torch.py",
    ROOT / "tools" / "time_after_profiler.py",
    ROOT / "tools" / "ring_size_torch.py"]
EXPORTER = ROOT / "tools" / "export_flax_npz.py"
JAX_SIDE_TOOLS = [ROOT / "tools" / "degrade_replay_jax.py",
                  ROOT / "tools" / "degrade_seeds_jax.py"]
# the committed export of the 10x10-4d policy that the evaluation tests load
POLICY = ROOT / "tests" / "fixtures" / "torch_weights" / "dmfb_10x10_4d_fov9_vdn"


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _code_names(path):
    """The modules a file imports (full dotted names) and the string
    constants of its code (docstrings, which may tell a reader where a
    file comes from, left out)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)):
            docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
            yield from (a.name for a in node.names)
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in docs):
            yield node.value


def test_no_port_file_names_the_exporter():
    """The exporter imports JAX; the port and its card tools read its output
    and neither import nor run it."""
    assert EXPORTER.is_file() and EXPORTER not in PORT_FILES
    assert "jax" in set(_imported_roots(EXPORTER))
    for path in PORT_FILES:
        named = [n for n in _code_names(path)
                 if re.search(r"\bexport_flax_npz\b", n)]
        assert not named, f"{path.relative_to(ROOT)} names {named}"


@pytest.mark.parametrize("tool", JAX_SIDE_TOOLS, ids=lambda p: p.name)
def test_no_port_file_names_a_jax_side_tool(tool):
    """The JAX-side sweep tools import JAX; no port file or card tool
    imports or runs them."""
    assert tool.is_file() and tool not in PORT_FILES
    assert "jax" in set(_imported_roots(tool))
    for path in PORT_FILES:
        named = [n for n in _code_names(path)
                 if re.search(rf"\b{tool.stem}\b", n)]
        assert not named, f"{path.relative_to(ROOT)} names {named}"


def test_exporter_scan_catches_a_use(tmp_path):
    f = tmp_path / "m.py"
    f.write_text('"""Made by tools/export_flax_npz.py."""\n'
                 "import subprocess\n"
                 "subprocess.run(['python', 'tools/export_flax_npz.py'])\n"
                 "from tools import export_flax_npz\n")
    names = list(_code_names(f))
    assert "python" in names and "export_flax_npz" in names
    assert "Made by tools/export_flax_npz.py." not in names


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for want in ("chip_smoke.py", "marl_dmfb_tpu_torch/envs/dmfb.py",
                 "marl_dmfb_tpu_torch/envs/dmfb_v01.py",
                 "marl_dmfb_tpu_torch/envs/meda.py",
                 "marl_dmfb_tpu_torch/envs/registry.py",
                 "marl_dmfb_tpu_torch/models/networks.py",
                 "marl_dmfb_tpu_torch/rollout.py",
                 "marl_dmfb_tpu_torch/eva_degrade.py",
                 "marl_dmfb_tpu_torch/ops/dmfb_step.py",
                 "marl_dmfb_tpu_torch/evaluate.py",
                 "marl_dmfb_tpu_torch/replay.py",
                 "marl_dmfb_tpu_torch/algos/qlearn.py",
                 "marl_dmfb_tpu_torch/checkpoint.py",
                 "marl_dmfb_tpu_torch/trainer.py",
                 "marl_dmfb_tpu_torch/train.py",
                 "marl_dmfb_tpu_torch/models/convert.py",
                 "marl_dmfb_tpu_torch/utils/platform.py",
                 "marl_dmfb_tpu_torch/utils/benchmarking.py",
                 "marl_dmfb_tpu_torch/parallel/mesh.py",
                 "marl_dmfb_tpu_torch/parallel/distributed.py",
                 "marl_dmfb_tpu_torch/utils/tracing.py"):
        assert want in names


def test_cuda_sources_include_no_pytorch_header():
    """Each kernel source under ``csrc/`` is plain ``extern "C"`` CUDA that
    nvcc builds in seconds: no PyTorch header (those take minutes, and the
    card's machine builds anew on every run)."""
    sources = sorted((ROOT / "marl_dmfb_tpu_torch" / "csrc").glob("*.cu"))
    assert [p.name for p in sources] == ["dmfb_step.cu", "dmfb_step_wide.cu",
                                         "meda_step.cu"]
    for path in sources:
        src = path.read_text()
        includes = re.findall(r"#include\s*[<\"]([^>\"]+)", src)
        assert not [h for h in includes
                    if h.split("/")[0] in ("torch", "ATen", "c10")], path
        assert 'extern "C" int ' in src, path


def test_mesh_ranks_import_nothing_of_jax(tmp_path):
    """``train --mesh=2`` and the ranks it starts (``torch.multiprocessing``
    children, which inherit the environment) run with ``jax`` and
    ``marl_dmfb_tpu`` made unimportable: a package of each name that raises
    stands first on ``PYTHONPATH``."""
    import os
    import subprocess
    import sys

    poison = tmp_path / "poison"
    for name in ("jax", "marl_dmfb_tpu"):
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(
            f"raise ImportError('{name} imported by the port')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(poison), str(ROOT)]))
    out = subprocess.run(
        [sys.executable, "-m", "marl_dmfb_tpu_torch.train", "dmfb",
         "--drop_num=2", "--fov=5", "--chip_size=5", "--exact_steps=40",
         "--n_parallel_envs=2", "--mesh=2", "--evaluate_task=2",
         "--buffer_size=8", "--batch_size=4", "--device=cpu",
         f"--data_dir={tmp_path / 'run'}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "mesh: 2 devices, sharding env batch" in out.stdout
    assert (tmp_path / "run" / "model" / "vdn" / "fov5"
            / "0_final_state.pt").is_file()


def test_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom marl_dmfb_tpu.envs import dmfb\n"
                 "def g():\n    import jax.numpy as jnp\n")
    assert {"marl_dmfb_tpu", "jax"} <= set(_imported_roots(f))


def test_evaluate_defaults_to_cuda_and_raises_without_it():
    from marl_dmfb_tpu_torch import evaluate
    from marl_dmfb_tpu_torch.config import get_evaluate_args

    assert get_evaluate_args(["dmfb"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(["dmfb", "--drop_num=4", "--fov=9",
                       "--evaluate_task=2"])


def test_evaluate_runs_on_cpu_when_asked():
    from marl_dmfb_tpu_torch import evaluate

    m = evaluate.main(["dmfb", "--drop_num=4", "--fov=9",
                       "--evaluate_task=3", "--device", "cpu",
                       f"--data_dir={POLICY}"])
    assert set(m) == {"reward", "steps", "constraints", "success_rate"}
    assert 0 < m["steps"] <= 40 and 0.0 <= m["success_rate"] <= 1.0
    rows = evaluate.main(["dmfb", "--boards=10,12", "--evaluate_task=2",
                          "--device=cpu", f"--data_dir={POLICY}"])
    assert [size for size, _ in rows] == [10, 12]


@pytest.mark.parametrize("flag", ["--show", "--show_save"])
def test_unported_evaluate_options_raise(flag, tmp_path, monkeypatch):
    """The rendering options were refused until the renderer was ported;
    now they render the evaluation (a window without a display under
    SDL's dummy video output, a video where the data dir is) and return its
    metrics."""
    import shutil

    from marl_dmfb_tpu_torch import evaluate

    pytest.importorskip("pygame" if flag == "--show" else "cv2")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    shutil.copytree(POLICY, tmp_path, dirs_exist_ok=True)
    m = evaluate.main(["dmfb", "--evaluate_task=2", "--device=cpu", flag,
                       f"--data_dir={tmp_path}"])
    assert 0.0 <= m["success_rate"] <= 1.0
    assert len(m["per_episode"]["success"]) == 2
    assert (tmp_path / "video").exists() == (flag == "--show_save")


def test_evaluate_load_model_without_checkpoint_raises(tmp_path):
    from marl_dmfb_tpu_torch import evaluate

    want = tmp_path / "model" / "vdn" / "fov9" / "0_final_state.pt"
    with pytest.raises(FileNotFoundError, match=f"no checkpoint at {want}"):
        evaluate.main(["dmfb", "--evaluate_task=2", "--device=cpu",
                       "--load_model", f"--data_dir={tmp_path}"])
