"""The harness, its readers and its parts load no JAX and no JAX
package; the reference loads nothing of the program; configurations,
mixes, metrics, parts and kernel names are found by name."""

from __future__ import annotations

import ast
import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "flydog_sdr_gps_tpu"}


def run_py(code: str, cwd: str = ROOT) -> str:
    env = dict(os.environ, PYTHONPATH=cwd)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def names(folder: str) -> list[str]:
    return [os.path.basename(p)[:-3] for p in
            glob.glob(os.path.join(folder, "*.py"))
            if not os.path.basename(p).startswith("_")]


def imported(path: str) -> list[str]:
    """Top-level names of the modules a file imports."""
    out = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module.split(".")[0])
    return out


def test_harness_readers_and_parts_load_no_jax():
    readers = names(os.path.join(HERE, "metrics"))
    parts = [(os.path.join(HERE, "parts"), n)
             for n in names(os.path.join(HERE, "parts"))]
    parts += [(os.path.join(HERE, "tests", "parts"), n)
              for n in names(os.path.join(HERE, "tests", "parts"))]
    assert parts
    for folder, n in parts:
        path = os.path.join(folder, n + ".py")
        assert not set(imported(path)) & FORBIDDEN, path
    out = run_py(
        "import sys, json\n"
        "from benchmark import run, harness, report, control\n"
        "import flydog_sdr_gps_tpu_torch.server, "
        "flydog_sdr_gps_tpu_torch.runtime\n"
        f"for r in {readers!r}: harness.reader(r)\n"
        f"for folder, n in {parts!r}:\n"
        "    harness.PARTS = folder\n"
        "    harness.part(n)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert not top & FORBIDDEN, top & FORBIDDEN
    assert "flydog_sdr_gps_tpu_torch" in top     # the port itself is allowed


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(HERE, "reference", "*.py")):
        for n in imported(path):
            assert n not in FORBIDDEN | {"flydog_sdr_gps_tpu_torch"}, \
                (path, n)
    out = run_py("import sys, json\n"
                 "import benchmark.reference.judge, "
                 "benchmark.reference.waterfall\n"
                 "print(json.dumps(sorted({m.split('.')[0] "
                 "for m in sys.modules})))")
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert not top & (FORBIDDEN | {"flydog_sdr_gps_tpu_torch"})


def digest(folder: str) -> dict:
    out = {}
    for p in glob.glob(os.path.join(folder, "**", "*"), recursive=True):
        if os.path.isfile(p) and "__pycache__" not in p:
            out[os.path.relpath(p, folder)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    before = digest(str(bench))
    with open(bench / "configs" / "kiwi12k_c4096.json") as f:
        cfg = json.load(f)
    (bench / "configs" / "tiny_c64.json").write_text(json.dumps(
        dict(cfg, name="tiny_c64", channels=64, adc_ppm=0.4,
             parts=["two_chans"])))
    (bench / "traffic" / "two_usb.json").write_text(json.dumps(dict(
        pacing="free", listeners=[dict(what="usb", mod="usb", low_cut=300,
                                       high_cut=2700, freq_khz=[14200.0, 5.0],
                                       count=2, compression=0)])))
    (bench / "metrics" / "blocks_seen.py").write_text(
        "def read(ctx, name):\n"
        "    return float(sum(1 for s in ctx['spans'] "
        "if s[0] == 'server.fanout'))\n")
    (bench / "kernels" / "stage2_roofline_pct" / "renamed.txt").write_text(
        "stage2_rot_v2\n")
    (bench / "parts" / "two_chans.py").write_text(
        "NUMBERS = ('chans',)\n"
        "def build(ctx):\n"
        "    return {'wf_chans': 2}\n"
        "def numbers(ctx):\n"
        "    return {'chans': 2.0}\n")
    (bench / "reference" / "limits" / "tiny_c64.two_usb.json").write_text(
        json.dumps({"limits": {"audio": 0.5, "missing": 0, "chans": 2}}))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(name="tiny_c64", source="test", file=
                             "benchmark/configs/tiny_c64.json", reduced=[],
                             why="test"))
    b["workloads"].append(dict(name="tiny_c64.two_usb", config="tiny_c64",
                               traffic="two_usb", chips=1, why="test"))
    b["per_layer"].append(dict(name="blocks_seen.free", unit="n",
                               better="higher", source="program_span",
                               layer="test", moves="rt_factor",
                               workloads=["tiny_c64.two_usb"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    out = run_py(
        "import json\n"
        "from benchmark import harness\n"
        "from benchmark.reference import judge\n"
        "c = harness.find_cell('.', 'tiny_c64.two_usb')\n"
        "r = harness.reader('blocks_seen.free')\n"
        "n = r({'spans': [('server.fanout', 0, 0.0, 1.0)] * 3}, "
        "'blocks_seen.free')\n"
        "p = [harness.part(name) for name in c.cfg['parts']]\n"
        "print(json.dumps([c.cfg['channels'], len(c.mix['listeners']), "
        "[m['name'] for m in c.per_layer], n, "
        "harness.kernel_names('stage2_roofline_pct'), "
        "judge.limits('tiny_c64.two_usb'), "
        "[m.build({}) for m in p], c.cfg['adc_ppm']]))",
        cwd=str(tmp_path))
    channels, groups, metrics, n, kernels, lim, built, ppm = json.loads(
        out.strip().splitlines()[-1])
    assert lim == {"audio": 0.5, "missing": 0.0, "chans": 2.0}
    assert built == [{"wf_chans": 2}] and ppm == 0.4
    assert channels == 64 and groups == 1 and n == 3.0
    assert "blocks_seen.free" in metrics
    assert "stage2_rot_v2" in kernels and "stage2_kernel<" in kernels
    after = digest(str(bench))
    assert {k: v for k, v in after.items() if k in before} == before
