"""``scripts/torch_make_experiments_tables.py`` over dry-run records:
every record gets exactly one row in its mesh's table, with its status.

``experiments/dryrun_torch/`` is written by ``python -m
repro_torch.launch.dryrun`` and is not in git, so the test renders
``tests/fixtures/dryrun_torch/``: records that command wrote (smollm-360m
and mamba2-370m: ``ok`` train, prefill and decode cells on both meshes,
the int8 cache's, mamba2's long-context cells, and smollm's ``skipped``
ones), plus, in a copy, one made ``error``."""
import importlib.util
import json
import os
import shutil

import pytest

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
FIXTURES = os.path.join(REPO, "tests", "fixtures", "dryrun_torch")


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_make_experiments_tables",
        os.path.join(REPO, "scripts", "torch_make_experiments_tables.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tables(text: str) -> dict:
    """{table title: [row cells]} of the rendered markdown."""
    out, title = {}, None
    for line in text.splitlines():
        if line.startswith("#"):
            title = line.lstrip("#").strip()
            out[title] = []
        elif line.startswith("| ") and not line.startswith("| arch"):
            out[title].append([c.strip() for c in line.strip("|")
                               .split("|")])
    return out


@pytest.fixture
def records(tmp_path):
    """The fixture records, and a copy of one made ``error``."""
    d = tmp_path / "dryrun_torch"
    shutil.copytree(FIXTURES, d)
    with open(d / "smollm_360m__prefill_32k__single.json") as f:
        rec = json.load(f)
    rec.update(mesh="multi", status="error",
               error="RuntimeError: out of memory\nsecond line")
    for k in ("roofline", "collectives", "memory"):
        rec.pop(k)
    with open(d / "smollm_360m__prefill_32k__multi.json", "w") as f:
        json.dump(rec, f)
    return d


def test_one_row_per_record_with_its_status(records, capsys):
    mod = _script()
    status = mod.main(["--dir", str(records)])
    text = capsys.readouterr().out
    recs = mod.load(str(records))
    assert len(recs) == len(os.listdir(FIXTURES)) + 1
    assert status == {"ok": 9, "skipped": 3, "error": 1}
    assert text.startswith("<!-- generated by scripts/torch_make_experiments"
                           "_tables.py: 9 ok / 3 skipped / 1 errors -->")
    tables = _tables(text)
    titles = {mesh: title for mesh, title, _ in mod.MESHES}
    for (arch, shape, mesh), rec in recs.items():
        rows = [r for r in tables[titles[mesh]]
                if r[:2] == [arch, shape]]
        assert len(rows) == 1, (arch, shape, mesh)
        assert rows[0][2].split(" ")[0] == rec["status"]
        if rec["status"] == "ok":
            m = rec["memory"]
            assert rows[0][3] == str(rec.get("accum_steps", 1))
            assert float(rows[0][8]) == pytest.approx(
                (m["argument_size_in_bytes"] + m["temp_size_in_bytes"])
                / 2 ** 30, abs=5e-3)
        elif rec["status"] == "skipped":
            assert rec["reason"] in rows[0][2]
        else:
            assert "out of memory" in rows[0][2]
    # a cell its mesh runs with no record
    assert ["chameleon_34b", "train_4k", "MISSING"] == \
        [r for r in tables[titles["single"]]
         if r[:2] == ["chameleon_34b", "train_4k"]][0][:3]
    # the roofline: one row per ok record of the single-pod meshes
    for mesh in ("single", "single__kvq8"):
        rows = tables[mesh]
        want = sorted((a, s) for (a, s, m), r in recs.items()
                      if m == mesh and r["status"] == "ok")
        assert sorted((r[0], r[1]) for r in rows) == want
        for r in rows:
            assert r[5] == recs[r[0], r[1], mesh]["roofline"][
                "dominant"].replace("_s", "")


def test_no_records_renders_every_cell_missing(tmp_path, capsys):
    mod = _script()
    assert mod.main(["--dir", str(tmp_path)]) == {}
    rows = _tables(capsys.readouterr().out)
    for mesh, title, shapes in mod.MESHES:
        assert len(rows[title]) == len(mod.ARCHS) * len(shapes)
        assert all(r[2] == "MISSING" for r in rows[title])
