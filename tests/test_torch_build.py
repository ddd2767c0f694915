"""The kernel build's cache key: a library is keyed on its source, on every
header beside it and on the flags, so an edited header is rebuilt (here on
a copy of ``csrc/``: nothing is compiled)."""
import shutil

from repro_torch.kernels import _build


def copy_csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


def test_sources_and_headers_are_in_csrc():
    names = {p.name for p in _build.sources()}
    assert {"seq_hist.cu", "tspm_fused.cu"} <= names
    assert (_build.CSRC / "bucket_count.cuh").exists()


def test_library_path_changes_with_an_included_header(tmp_path):
    csrc = copy_csrc(tmp_path)
    src = csrc / "seq_hist.cu"
    before = _build.library_path(src)
    assert before == _build.library_path(src)           # stable
    header = csrc / "bucket_count.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(src) != before


def test_library_path_changes_with_a_new_header(tmp_path):
    csrc = copy_csrc(tmp_path)
    src = csrc / "tspm_pairgen.cu"
    before = _build.library_path(src)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path(src) != before


def test_library_path_changes_with_the_source(tmp_path):
    csrc = copy_csrc(tmp_path)
    src = csrc / "tspm_fused.cu"
    before = _build.library_path(src)
    src.write_text(src.read_text() + "\n")
    assert _build.library_path(src) != before


def test_probe_builds_live_apart(tmp_path):
    src = copy_csrc(tmp_path) / "seq_hist.cu"
    main = _build.library_path(src)
    probe = _build.library_path(src, "COUNT_PROBES")
    assert main.parent == _build.BUILD_DIR and probe.parent == _build.PROBE_DIR
    assert probe.name.startswith("seq_hist-count_probes-") and probe != main
