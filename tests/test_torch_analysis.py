"""The port's lint (repro_torch.analysis) in both directions: the live tree
passes all seven checks, and each check fires on its seeded-violation
fixture tree, through the API and through the CLI (exit code 1).

The fixtures live under tests/analysis_fixtures/torch_<check>/ — inside a
directory named `analysis_fixtures`, which both packages' lints skip when
they scan a checkout, and with no file matching test_*.py, so pytest never
collects them:

  torch_parity/       kernel_parity   a wrapper with no plain version,
                                      dispatch entry, test, phase-2 case
                                      or CUDA source
  torch_registry/     registry        kind `zq` missing from
                                      quant_variants and every wiring; a
                                      hand quant list in chip_smoke.py
  torch_dead_knobs/   dead_knobs      `SearchConfig.phantom_knob` never
                                      read (`max_hops` live through
                                      `hops_bound`)
  torch_sync_safety/  sync_safety     if / assert / float() / .item() /
                                      nonzero on device tensors, and a
                                      stale allowlist entry
  torch_smem_budget/  smem_budget     a 256 KiB static tile; dynamic
                                      shared memory with no formula
  torch_docs_xref/    docs_xref       a §3 gap and a citation of §9
  torch_cost/         cost            `mystery_scan` with no KERNEL_COSTS
                                      formula

Plus unit coverage of the parts the fixtures do not pin: the 14 kernels
and their launcher symbols, the property bridge, the sync allowlist, the
static shared bytes, and that the lint imports no torch.
"""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import (CHECKS, cost, default_root, knobs, parity,
                                  run_all, run_check, smem, tracing)
from repro_torch.analysis.common import (Tree, assigned_dict_keys,
                                         class_def, dataclass_fields)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "analysis_fixtures"

FIXTURE_FOR = {check: "torch_" + ("parity" if check == "kernel_parity"
                                  else check) for check in CHECKS}


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


# ------------------------------------------------------------ clean tree
def test_seven_checks():
    assert sorted(CHECKS) == sorted(
        ["kernel_parity", "registry", "dead_knobs", "sync_safety",
         "smem_budget", "docs_xref", "cost"])


def test_clean_tree_passes():
    violations = run_all(ROOT)
    assert violations == [], "\n".join(str(v) for v in violations)


def test_default_root_is_this_checkout():
    assert default_root() == ROOT


def test_cli_exit_zero_on_clean_tree():
    r = _cli("--report")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 violation(s)" in r.stdout
    assert "warp_step_kernel" in r.stdout        # the smem table
    assert "bool(active.any())" in r.stdout      # the allowlisted syncs


def test_lint_imports_no_torch():
    code = ("import sys\n"
            "from repro_torch.analysis import run_all, default_root\n"
            "assert run_all(default_root()) == []\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'repro'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr


# --------------------------------------------------------- checks fire
@pytest.mark.parametrize("check", sorted(CHECKS))
def test_fixture_fires(check):
    violations = run_check(check, FIXTURES / FIXTURE_FOR[check])
    own = [v for v in violations if v.check == check]
    assert own, f"{check} did not fire on its seeded fixture"


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_cli_exit_nonzero_on_fixture(check):
    r = _cli("--root", str(FIXTURES / FIXTURE_FOR[check]), "--check", check)
    assert r.returncode == 1, r.stdout + r.stderr
    assert f"[{check}]" in r.stdout


def test_fixture_messages_name_the_seeded_violation():
    knob = run_check("dead_knobs", FIXTURES / "torch_dead_knobs")
    assert any("phantom_knob" in v.message for v in knob)
    assert not any("max_hops" in v.message for v in knob)

    reg = run_check("registry", FIXTURES / "torch_registry")
    assert any("zq" in v.message for v in reg)
    assert any("hand-enumerated" in v.message for v in reg)

    sync = run_check("sync_safety", FIXTURES / "torch_sync_safety")
    kinds = {m for v in sync for m in ("`if`", "`assert`", "`float()`",
                                       "`.item()`", "`nonzero`",
                                       "matches no sync")
             if m in v.message}
    assert len(kinds) == 6, sync
    # the static assert on d.shape is no sync
    assert not any("d.shape" in v.message for v in sync)

    sm = run_check("smem_budget", FIXTURES / "torch_smem_budget")
    assert any("huge_tile_kernel" in v.message and "227 KiB" in v.message
               for v in sm)
    assert any("huge_tile_kernel" in v.message and "228 KiB" in v.message
               for v in sm)
    assert any("dynamic_kernel" in v.message and "DYNAMIC" in v.message
               for v in sm)

    docs = run_check("docs_xref", FIXTURES / "torch_docs_xref")
    assert any("§3 missing" in v.message for v in docs)
    assert any("§9" in v.message for v in docs)

    par = run_check("kernel_parity", FIXTURES / "torch_parity")
    assert any("rowcopy" in v.message for v in par)

    cst = run_check("cost", FIXTURES / "torch_cost")
    assert any("mystery_scan" in v.message for v in cst)


def test_fixture_files_are_never_collected():
    files = [p for p in FIXTURES.rglob("*") if p.is_file()
             and p.relative_to(FIXTURES).parts[0].startswith("torch_")]
    assert files
    assert not [p for p in files if re.fullmatch(r"test_.*\.py", p.name)]


# ----------------------------------------------------------- the kernels
def _phase2_kernels():
    return set(assigned_dict_keys(ast.parse(
        (ROOT / "chip_smoke.py").read_text()), "KERNEL_SOURCES"))


def test_parity_finds_the_14_kernels():
    """The 14 counterparts of the JAX package's Pallas kernels, and
    beam_filter, the one kernel of the port that replaces none."""
    names = {name for _, name, _ in parity.find_kernels(Tree(ROOT))}
    assert len(names) == 15
    assert names == _phase2_kernels()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    ported = {name for name, (_, rep, _) in chip_smoke.KERNEL_SOURCES.items()
              if rep.startswith("src/repro/kernels/")}
    assert len(ported) == 14
    assert names - ported == {"beam_filter"}


def test_cost_has_an_entry_for_every_kernel():
    est = cost.estimate(Tree(ROOT))
    assert {e.name for e in est} == \
        set(cost.KERNEL_COSTS) | set(cost.PORT_KERNEL_COSTS) \
        == _phase2_kernels()
    assert set(cost.PORT_KERNEL_COSTS) == {"beam_filter"}
    for e in est:
        assert not e.notes and e.flops > 0 and e.hbm_bytes > 0, e


def test_every_launcher_symbol_is_an_extern_c_definition():
    pairs = parity._Kernels(Tree(ROOT)).launcher_symbols()
    assert len(pairs) == 15          # one C launcher a kernel
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    for _, _, src, sym in pairs:
        assert sym in parity.extern_c_symbols(
            (csrc / f"{src}.cu").read_text()), (src, sym)


def test_extern_c_declarations_are_not_definitions():
    text = ('extern "C" int a_f32(const void* q, int n);\n'
            'extern "C" int b_f32(const void* q,\n    int n) {\n'
            '  return 0;\n}\n')
    assert parity.extern_c_symbols(text) == {"b_f32"}


# ------------------------------------------------------------- the rest
def test_property_bridge_keeps_two_fields_live():
    """max_hops is read only through hops_bound and pq_bits only through
    nbits; dead_knobs keeps both live by the bridge."""
    tree = Tree(ROOT)
    types_mod = tree.parse(knobs.TYPES)
    reads = knobs._attr_reads(tree, skip_module=knobs.TYPES)
    unread = {(c, f) for c in knobs.CLASSES
              for f, _ in dataclass_fields(class_def(types_mod, c))
              if f not in reads}
    assert unread == {("SearchConfig", "max_hops"),
                      ("QuantConfig", "pq_bits")}
    assert knobs.run(tree) == []


def test_sync_allowlist_names_the_two_syncs_of_the_search_path():
    found = tracing.syncs(Tree(ROOT))
    assert {s.key for s in found} == set(tracing.ALLOWED)
    where = {(s.path.rsplit("/", 2)[-2] + "/" + s.path.rsplit("/", 1)[-1],
              s.source): s.line for s in found}
    assert set(where) == {("core/search.py", "bool(active.any())"),
                          ("core/build.py", "torch.nonzero(tied)")}
    for s in found:
        line = (ROOT / s.path).read_text().splitlines()[s.line - 1]
        assert s.source in line, (s, line)


@pytest.mark.parametrize("body,flagged", [
    ("n = x.shape[0]\nif n > 2:\n    pass", False),
    ("if len(x):\n    pass", False),
    ("if y is None:\n    pass", False),
    ("if x.is_cuda and x.dim() == 2:\n    pass", False),
    ("v = x.sum()\nif v > 0:\n    pass", True),
    ("z = x + 1\nw = z.item()", True),
    ("rows = x.nonzero()", True),
    ("a = [t.tolist() for t in (x,)]", True),
    ("k = int(n_host)", False),
])
def test_sync_taint_rules(body, flagged):
    src = ("def f(x: torch.Tensor, y: Optional[torch.Tensor], n_host: "
           "int):\n" + "\n".join("    " + ln for ln in body.splitlines()))
    fn = ast.parse(src).body[0]
    assert bool(tracing._syncs_in(fn, "f.py")) == flagged


def test_smem_static_bytes():
    est = {k.name: k for k in smem.estimate(Tree(ROOT))}
    assert len(est) == 10
    # ids and ranks of kStepWarps warps, kWarpSortC each: 2 x 4 x 128 x 4
    assert est["warp_step_kernel"].static_bytes == 4096
    assert all(k.static_bytes == 0 for n, k in est.items()
               if n != "warp_step_kernel")
    assert est["scan_kernel"].min_blocks == 5
    assert est["batch_dist_kernel"].dynamic is not None
    # a queue tile and the row's ids: a block's one row at WORST (C =
    # 4,096), four warps' rows at C <= 32
    k = est["filter_kernel"]
    assert k.uses_dynamic and not k.notes
    assert k.worst_bytes == (1024 + 4096) * 4
    assert smem._eval(k.dynamic, {**smem.constants(
        (ROOT / "src/repro_torch/kernels/csrc/beam_filter.cu").read_text()),
        **smem.HELPERS, "C": 30, "L": 48}) == 4 * (48 + 32) * 4


# ------------------------------------------- chip_smoke's ptxas cross-check
_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116warp_step_kernelINS_11Pq4WarpDistILb1EEEEEvT_PKiPfPiS6_S7_iiiiibb' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116warp_step_kernelINS_11Pq4WarpDistILb1EEEEEvT_PKiPfPiS6_S7_iiiiibb
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 0 barriers, {smem} bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113expand_kernelINS_7F32DistILi3ELi1ELb1EEEEEvT_PKiPfPiS6_S7_iiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113expand_kernelINS_7F32DistILi3ELi1ELb1EEEEEvT_PKiPfPiS6_S7_iiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 16 bytes cumulative stack size
"""


def test_smoke_holds_static_smem_against_ptxas():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    text = _PTXAS.format(smem=4096)
    assert sorted(chip_smoke.ptxas_smem(text).values()) == [0, 4096]
    out = chip_smoke.phase_lint({"traverse_step": text})
    assert out["ptxas_smem"] == {"traverse_step/warp_step_kernel": 4096,
                                 "traverse_step/expand_kernel": 0}
    with pytest.raises(RuntimeError, match="below ptxas"):
        chip_smoke.phase_lint({"traverse_step": _PTXAS.format(smem=8192)})
    with pytest.raises(RuntimeError, match="matches 0"):
        chip_smoke.phase_lint({"pq_adc": text})
