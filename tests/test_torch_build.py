"""The kernels' build (``ops/build.py``) on the CPU: the library names, which
decide when a kernel is rebuilt.  No nvcc runs here."""

from mlp_ppo_2ply_p3_tpu_torch.ops import build


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """A library is named by its source and every header the source
    includes with quotes, recursively: an edit of any of them renames
    it (so it is rebuilt); a header it does not include, or a system
    header, does not."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include <stdint.h>\n#include "common.cuh"\n'
                               'int a;\n')
    (csrc / "common.cuh").write_text('#pragma once\n  #  include '
                                     '"deeper.cuh"\nint b;\n')
    (csrc / "deeper.cuh").write_text('#include "common.cuh"\nint c;\n')
    (csrc / "other.cuh").write_text("int d;\n")
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")

    assert build.source_files("a") == [
        (csrc / name).resolve() for name in ("a.cu", "common.cuh",
                                             "deeper.cuh")]
    names = [build.library_path("a")]
    assert names[0].parent == tmp_path / "build"
    assert names[0].name.startswith("liba_") and names[0].suffix == ".so"
    (csrc / "other.cuh").write_text("int d2;\n")
    assert build.library_path("a") == names[0]
    for edited in ("deeper.cuh", "common.cuh", "a.cu"):
        path = csrc / edited
        path.write_text(path.read_text() + "// edited\n")
        names.append(build.library_path("a"))
        assert names[-1] != names[-2], edited
    assert len(set(names)) == 4


def test_the_port_sources_and_their_header():
    """The six kernel sources; the two movegen ones share the rules in
    ``csrc/board.cuh``, the afterstate and dense ones the whole rows'
    helpers in ``csrc/whole_rows.cuh``, the Adam and compaction ones
    include none."""
    assert build.sources() == ("adam", "afterstate", "compaction", "dense",
                               "doubles", "nondoubles")
    for header, names in (("board.cuh", ("doubles", "nondoubles")),
                          ("whole_rows.cuh", ("afterstate", "dense"))):
        for name in names:
            assert build.source_files(name) == [
                (build.CSRC_DIR / f"{name}.cu").resolve(),
                (build.CSRC_DIR / header).resolve()]
    for name in ("adam", "compaction"):
        assert build.source_files(name) == [
            (build.CSRC_DIR / f"{name}.cu").resolve()]
