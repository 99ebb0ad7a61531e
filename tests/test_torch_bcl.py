"""BCL run folders in the port vs the JAX package, on the CPU.

The port's copies of `io/bcl.py` and `io/use_bases_mask.py` against the
originals (codecs, RunInfo, both tile layouts, masks), run folders written
by one package and read by the other, and the run-folder workflow: sorted
BAM(s), .bai, .md5 and the Stats JSON equal to the JAX workflow's with a
sample sheet and --per-tile-tls (two tiles with different insert sizes
learn different models), in the NextSeq layout with --use-bases-mask and
--tiles, in-process with per-lane libraries, and through the CLI.
"""

import dataclasses
import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from isaac_aligner_tpu.io import bcl as jbcl
from isaac_aligner_tpu.io import use_bases_mask as jmask
from isaac_aligner_tpu.workflow import align as jwf
from isaac_aligner_tpu_torch import synthetic
from isaac_aligner_tpu_torch.io import bcl, use_bases_mask
from isaac_aligner_tpu_torch.io.bam import read_bam
from isaac_aligner_tpu_torch.workflow import align as wf

from test_torch_paired import pair_genome, write_pair_inputs
from test_torch_workflow import _env

REPO = Path(__file__).resolve().parents[1]
BATCH = 64
BAM_FILES = ("sorted.bam", "sorted.bam.bai", "sorted.bam.md5")
#: Stats JSON fields that hold wall-clock seconds or the port's own
#: device-work counters; every other field is compared
UNTIMED = {"align_seconds", "stage_seconds", "build_seconds", "device_work"}
BARCODES = ("ACGTACGT", "TGCATGCA")


def output_files(out: Path) -> list[str]:
    """Every BAM-side output and Stats JSON under `out`, relative."""
    return sorted(p.relative_to(out).as_posix() for p in out.rglob("*")
                  if p.is_file() and "Temp" not in p.parts
                  and (p.name in BAM_FILES or p.suffix == ".json"))


def assert_outputs_equal(jout: Path, tout: Path) -> list[str]:
    """The port's outputs equal the JAX run's: BAM, .bai and .md5 bytes,
    every Stats JSON without its timing fields.  Returns the names."""
    names = output_files(jout)
    assert output_files(tout) == names
    for name in names:
        a, b = (jout / name).read_bytes(), (tout / name).read_bytes()
        if name.endswith(".json"):
            a, b = json.loads(a), json.loads(b)
            if isinstance(a, dict):
                a = {k: v for k, v in a.items() if k not in UNTIMED}
                b = {k: v for k, v in b.items() if k not in UNTIMED}
        assert a == b, name
    return names


def tile_pairs(seed: int = 7, per_tile: int = 160):
    """Pairs for two tiles on pair_genome's chrA: inserts N(300, 30) in
    the first tile's share, N(450, 30) in the second's, 5% damaged mates;
    index reads of BARCODES with 10% one-mismatch and 10% random ones, and
    5% of clusters failing the filter."""
    rng = np.random.default_rng(seed)
    g = pair_genome().codes[:16_000]
    parts = [synthetic.make_pairs(rng, g, per_tile, far_frac=0.0,
                                  insert=(ins, 30.0),
                                  insert_range=(ins - 100, ins + 100),
                                  damaged_frac=0.05)
             for ins in (300, 450)]
    b1 = np.concatenate([p.bases1 for p in parts])
    b2 = np.concatenate([p.bases2 for p in parts])
    index, _sample, _mm = synthetic.barcode_reads(rng, b1.shape[0],
                                                  list(BARCODES), 0.1, 0.1)
    pf = rng.random(b1.shape[0]) > 0.05
    return b1, b2, index, pf


def write_inputs(d: Path) -> Path:
    """d/ref.fa, d/sheet.csv, d/run (per-cycle .bcl.gz, lane 1, tiles
    1101 and 1102, .locs) and d/nextseq (BGZF layout, lane 2, tiles
    1101-1103, .clocs)."""
    write_pair_inputs(d, [], pair_genome())
    (d / "sheet.csv").write_text(
        "barcode,sample\n" + "".join(f"{b},S{i + 1}\n"
                                     for i, b in enumerate(BARCODES)))
    b1, b2, index, pf = tile_pairs()
    synthetic.write_pair_run_folder(d / "run", b1, b2, index,
                                    [(1, "per_cycle", [1101, 1102])], pf=pf)
    synthetic.write_pair_run_folder(d / "nextseq", b1, b2, index,
                                    [(2, "bgzf", [1101, 1102, 1103])],
                                    pf=pf, clocs=True)
    return d


@pytest.fixture(scope="module")
def inputs(tmp_path_factory) -> Path:
    return write_inputs(tmp_path_factory.mktemp("bcl_in"))


def _opts(mod, d: Path, out: Path, **kw):
    base = dict(reference=str(d / "ref.fa"), output_dir=str(out),
                run_folder=str(d / "run"), batch_size=BATCH)
    if mod is wf:
        base["device"] = "cpu"
    return mod.WorkflowOptions(**{**base, **kw})


_SHEET = {"sample_sheet": "SHEET", "bam_exclude_tags": "none"}
CASES = {
    "sheet_per_tile_tls": ({**_SHEET, "per_tile_tls": True}, {}),
    "sheet_in_process_lane_libraries": (
        {**_SHEET, "single_library_samples": False},
        {"ISAAC_TPU_OUTPUT_PROC": "0"}),
    "nextseq_mask_tiles": ({"run_folder": "NEXTSEQ",
                            "use_bases_mask": "y90n10,n8,y90n10",
                            "tiles_regex": "110[13]", "keep_unaligned":
                            "front"}, {}),
}


@pytest.fixture(scope="module")
def ran(inputs, tmp_path_factory):
    """case -> (JAX output dir, port output dir), each run once."""
    done: dict = {}

    def get(case: str):
        if case not in done:
            kw, env = CASES[case]
            kw = dict(kw)
            if kw.get("sample_sheet") == "SHEET":
                kw["sample_sheet"] = str(inputs / "sheet.csv")
            if kw.get("run_folder") == "NEXTSEQ":
                kw["run_folder"] = str(inputs / "nextseq")
            outs = []
            for mod in (jwf, wf):
                out = tmp_path_factory.mktemp(f"{case}_{mod.__name__[:18]}")
                with _env(env):
                    mod.AlignWorkflow(_opts(mod, inputs, out, **kw)).run()
                outs.append(out)
            done[case] = tuple(outs)
        return done[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_run_folder_workflow_equals_jax(case, ran):
    jout, tout = ran(case)
    names = assert_outputs_equal(jout, tout)
    ms = json.loads((tout / "Stats" / "MatchSelectorStats.json").read_text())
    assert ms["aligned"] > 0.9 * ms["total_reads"]
    tiles = {(t["lane"], t["tile"]) for t in ms["tiles"]}
    if case.startswith("sheet"):
        assert {"S1/sorted.bam", "S2/sorted.bam", "unknown/sorted.bam",
                "Stats/DemultiplexingStats.json"} <= set(names)
        assert not (tout / "sorted.bam").exists()
        assert tiles == {("1", "1101"), ("1", "1102")}
    else:
        assert "sorted.bam" in names
        assert tiles == {("2", "1101"), ("2", "1103")}


def test_per_tile_tls_learns_each_tiles_model(ran):
    jout, tout = ran("sheet_per_tile_tls")
    jstate = json.loads((jout / "Temp" / "AlignerState.json").read_text())
    tstate = json.loads((tout / "Temp" / "AlignerState.json").read_text())
    assert tstate["tls_by_tile"] == jstate["tls_by_tile"]
    assert tstate["tls"] == jstate["tls"]
    medians = {k: v["median"] for k, v in tstate["tls_by_tile"].items()}
    assert set(medians) == {"1:1101", "1:1102"}
    assert abs(medians["1:1101"] - 300) <= 15
    assert abs(medians["1:1102"] - 450) <= 15


def test_sample_bams_carry_rg_bc_and_positions(inputs, ran):
    """Each sample's records carry its RG, the observed barcode as BC and
    the cluster position (from the .locs) as ZX/ZY; the unknown BAM holds
    the unresolved barcodes."""
    _, tout = ran("sheet_per_tile_tls")
    for sample in ("S1", "S2", "unknown"):
        recs = read_bam(tout / sample / "sorted.bam")[2]
        assert recs
        for r in recs[:50]:
            assert r.tags["RG"] == ("Z", sample)
            x, y = r.qname.split(":")[-2:]
            assert r.tags["ZX"] == ("i", int(x))
            assert r.tags["ZY"] == ("i", int(y))
            bc = r.tags["BC"][1]
            if sample != "unknown":
                want = BARCODES[int(sample[1]) - 1]
                assert sum(a != b for a, b in zip(bc, want)) <= 1


def test_cli_run_folder_with_sample_sheet(inputs, ran, tmp_path):
    jout, _ = ran("sheet_per_tile_tls")
    out = tmp_path / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "isaac_aligner_tpu_torch", "align",
         "-r", str(inputs / "ref.fa"), "--run-folder", str(inputs / "run"),
         "--sample-sheet", str(inputs / "sheet.csv"), "--per-tile-tls", "1",
         "--bam-exclude-tags", "none", "-o", str(out),
         "--batch-size", str(BATCH), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert_outputs_equal(jout, out)


def test_per_tile_tls_refused_with_processes(inputs, tmp_path):
    """--per-tile-tls with several processes raises, as in JAX."""
    run = wf.AlignWorkflow(_opts(wf, inputs, tmp_path / "out",
                                 per_tile_tls=True,
                                 tls_override="200:300:400:20:20:1:6"))
    run._dist_cached = (0, 2)
    with pytest.raises(ValueError, match="per-tile-tls"):
        run.run()
    assert run.state == "TlsDone"


# -- host copies ------------------------------------------------------------


def _info(mod, read_cycles=(12, 12), index_cycles=(6,), lanes=2):
    reads = [mod.ReadSegment(i + 1, c, False) for i, c in enumerate(read_cycles)]
    reads += [mod.ReadSegment(len(reads) + i + 1, c, True)
              for i, c in enumerate(index_cycles)]
    return mod.RunInfo(flowcell="FCX", instrument="M001", run_number=7,
                       reads=reads, lane_count=lanes)


def test_run_info_equals_jax(tmp_path):
    bcl.write_run_info(tmp_path / "p", _info(bcl))
    jbcl.write_run_info(tmp_path / "j", _info(jbcl))
    assert (tmp_path / "p" / "RunInfo.xml").read_bytes() == \
        (tmp_path / "j" / "RunInfo.xml").read_bytes()
    got = bcl.parse_run_info(tmp_path / "j")
    want = jbcl.parse_run_info(tmp_path / "j")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [(dataclasses.asdict(s), a, b) for s, a, b in got.cycle_ranges()] \
        == [(dataclasses.asdict(s), a, b) for s, a, b in want.cycle_ranges()]


def _codec_inputs():
    rng = np.random.default_rng(3)
    bases = rng.integers(0, 5, 300).astype(np.uint8)
    quals = rng.integers(0, 42, 300).astype(np.uint8)
    x = rng.uniform(0, 2000, 300).astype(np.float32)
    y = rng.uniform(0, 2000, 300).astype(np.float32)
    return bases, quals, x, y


@pytest.mark.parametrize("name", ["c.bcl", "c.bcl.gz", "c.bcl.bgzf",
                                  "s.filter", "s.locs"])
def test_codecs_equal_jax(tmp_path, name):
    bases, quals, x, y = _codec_inputs()
    port, jax_ = tmp_path / f"port_{name}", tmp_path / f"jax_{name}"
    for mod, path in ((bcl, port), (jbcl, jax_)):
        if name.endswith(".filter"):
            mod.write_filter(path, bases > 1)
        elif name.endswith(".locs"):
            mod.write_locs(path, x, y)
        else:
            mod.write_bcl(path, bases, quals)
    if not name.endswith(("gz", "bgzf")):
        assert port.read_bytes() == jax_.read_bytes()
    reader = {"filter": "read_filter", "locs": "read_locs"}.get(
        name.rsplit(".", 1)[-1], "read_bcl")
    for path in (port, jax_):
        got = getattr(bcl, reader)(path)
        want = getattr(jbcl, reader)(path)
        for a, b in zip(np.atleast_2d(got), np.atleast_2d(want)):
            np.testing.assert_array_equal(a, b)


def test_clocs_written_by_port_read_by_both(tmp_path):
    """write_clocs (the port's writer for fixtures) round-trips through
    both packages' readers, including an empty and a crowded bin."""
    rng = np.random.default_rng(4)
    bins = np.sort(rng.integers(0, 82 * 6, 400))
    bins[10:14] = bins[10]
    dx = rng.integers(0, 250, 400)
    dy = rng.integers(0, 250, 400)
    x = (bins % 82) * 25 + dx / 10.0
    y = (bins // 82) * 25 + dy / 10.0
    bcl.write_clocs(tmp_path / "s.clocs", x, y)
    for mod in (bcl, jbcl):
        cx, cy = mod.read_clocs(tmp_path / "s.clocs")
        np.testing.assert_array_equal(cx, 250 * (bins % 82) + dx + 1000)
        np.testing.assert_array_equal(cy, 250 * (bins // 82) + dy + 1000)
    with pytest.raises(ValueError, match="bin order"):
        bcl.write_clocs(tmp_path / "bad.clocs", x[::-1], y[::-1])


def test_clocs_hand_built_equals_jax(tmp_path):
    payload = bytearray([1]) + struct.pack("<I", 84)
    for b in range(84):
        payload += {0: bytes([2, 10, 20, 250, 0]),
                    83: bytes([1, 5, 15])}.get(b, bytes([0]))
    (tmp_path / "s.clocs").write_bytes(bytes(payload))
    got, want = bcl.read_clocs(tmp_path / "s.clocs"), \
        jbcl.read_clocs(tmp_path / "s.clocs")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _tile_arrays(n=40, rl=12, il=6, seed=5):
    rng = np.random.default_rng(seed)
    segs = [(rng.integers(0, 5, (n, c)).astype(np.uint8),
             rng.integers(2, 41, (n, c)).astype(np.uint8))
            for c in (rl, rl, il)]
    return segs, rng.random(n) > 0.2


def _write_run(mod, run: Path, layout: str):
    """A two-lane-capable run folder in `layout` written by `mod`."""
    segs, pf = _tile_arrays()
    info = _info(mod)
    if layout == "per_cycle":
        for tile in (1101, 1102):
            mod.write_run_folder(run, info, 1, tile, segs, pf=pf,
                                 compress=tile == 1102)
    else:
        segs2, _ = _tile_arrays(seed=6)
        mod.write_run_folder_bgzf(run, info, 1, [(1101, segs), (1102, segs2)])
    return info


LOADS = {
    "per_cycle": {},
    "per_cycle_mask": {"use_bases_mask": "y10n2,n*,i6"},
    "per_cycle_missing_bcl": {"ignore_missing_bcls": True},
    "bgzf": {},
    "bgzf_mask": {"use_bases_mask": "y*,y11n,n6"},
}


@pytest.mark.parametrize("case", list(LOADS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_tile_equals_jax_across_writers(tmp_path, case, writer):
    """A run folder written by either package loads the same in both."""
    layout = "bgzf" if case.startswith("bgzf") else "per_cycle"
    run = tmp_path / "run"
    _write_run(jbcl if writer == "jax" else bcl, run, layout)
    if case == "per_cycle_missing_bcl":
        (run / "Data/Intensities/BaseCalls/L001/C3.1/s_1_1101.bcl").unlink()
    kw = LOADS[case]
    assert bcl.discover_lanes(run) == jbcl.discover_lanes(run) == [1]
    assert bcl.discover_tiles(run, 1) == jbcl.discover_tiles(run, 1) \
        == [1101, 1102]
    info = bcl.parse_run_info(run)
    for tile in (1101, 1102):
        assert bcl.peek_tile_cluster_count(run, 1, tile) == \
            jbcl.peek_tile_cluster_count(run, 1, tile)
        got = bcl.load_tile(run, 1, tile, **kw)
        want = jbcl.load_tile(run, 1, tile, **kw)
        for field in ("lane", "tile", "barcode_bases", "pf", "x", "y"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field), field)
        assert len(got.read_bases) == len(want.read_bases)
        for a, b in zip(got.read_bases + got.read_quals,
                        want.read_bases + want.read_quals):
            np.testing.assert_array_equal(a, b)
        for pf_only in (True, False):
            gb, gbar = bcl.tile_read_batches(got, info, pf_only)
            wb, wbar = jbcl.tile_read_batches(want, jbcl.parse_run_info(run),
                                              pf_only)
            np.testing.assert_array_equal(gbar, wbar)
            for a, b in zip(gb, wb):
                assert list(a.names) == list(b.names)
                np.testing.assert_array_equal(a.bases, b.bases)
                np.testing.assert_array_equal(a.quals, b.quals)
    p1, p2, pbar = bcl.load_run_reads(run, **kw)
    j1, j2, jbar = jbcl.load_run_reads(run, **kw)
    np.testing.assert_array_equal(pbar, jbar)
    for a, b in ((p1, j1), (p2, j2)):
        if b is None:
            assert a is None
            continue
        assert list(a.names) == list(b.names)
        np.testing.assert_array_equal(a.bases, b.bases)


def test_missing_files_raise_as_in_jax(tmp_path):
    run = tmp_path / "run"
    _write_run(bcl, run, "per_cycle")
    (run / "Data/Intensities/BaseCalls/L001/C2.1/s_1_1101.bcl").unlink()
    (run / "Data/Intensities/BaseCalls/L001/s_1_1102.filter").unlink()
    for tile in (1101, 1102):
        errors = []
        for mod in (bcl, jbcl):
            with pytest.raises(FileNotFoundError) as e:
                mod.load_tile(run, 1, tile)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    got = bcl.load_tile(run, 1, 1102, ignore_missing_filters=True)
    assert got.pf.all()


MASKS = [("y12,y12,i6", (12, 12, 6)), ("y*,n*,i*", (12, 12, 6)),
         ("y10n2,y11n,i6", (12, 12, 6)), ("Y5N7,y12,I6", (12, 12, 6)),
         ("n12,y12,n6", (12, 12, 6)), ("y13,y12,i6", (12, 12, 6)),
         ("y12,y12", (12, 12, 6)), ("y*n*,y12,i6", (12, 12, 6)),
         ("y12,y12,x6", (12, 12, 6)), ("n12,n12,i6", (12, 12, 6))]


@pytest.mark.parametrize("mask,cycles", MASKS)
def test_use_bases_mask_equals_jax(mask, cycles):
    outs = []
    for mod, bmod in ((use_bases_mask, bcl), (jmask, jbcl)):
        info = _info(bmod, read_cycles=cycles[:2], index_cycles=cycles[2:])
        try:
            outs.append(("ok", mod.parse_use_bases_mask(mask, list(cycles)),
                         mod.effective_segments(info, mask)))
        except ValueError as e:
            outs.append(("error", str(e)))
    assert outs[0] == outs[1]
    for entry, n in (("y3n*", 7), ("i*", 4), ("y2y2", 4)):
        assert use_bases_mask.parse_entry(entry, n) == jmask.parse_entry(entry, n)


def test_sharded_rescue_follows_the_batch_tls():
    """A per-tile model riding the batch (`tls_hint`) sets the sharded
    program's rescue window, and the skip count that `_apply_rescue`
    reckons on the masked copy follows it: a global model too wide to
    rescue does not mark the hinted batch's rows as skipped."""
    from isaac_aligner_tpu.index.build import build_index
    from isaac_aligner_tpu_torch.align.pairs import TlsStatic
    from isaac_aligner_tpu_torch.io.fastq import ReadBatch
    from isaac_aligner_tpu_torch.parallel.sharded import make_mesh
    from isaac_aligner_tpu_torch.parallel.sharded_aligner import \
        ShardedPairedAligner

    from test_torch_host import to_port_index
    from test_torch_paired import pair_rows

    genome = pair_genome()
    rows = pair_rows(genome.codes)
    index = to_port_index(build_index(genome, seed_len=32))
    al = ShardedPairedAligner.create_sharded(
        index, mesh=make_mesh(2, device="cpu"), read_len=100)
    al.tls = TlsStatic(min=100, max=9_000, mate_min=100, mate_max=9_000,
                       best0=1, best1=6, median=300)

    def batch(col, qcol):
        return ReadBatch([r[0] for r in rows], np.stack([r[col] for r in rows]),
                         np.stack([r[qcol] for r in rows]),
                         np.full(len(rows), 100, np.int32))
    b1, b2 = batch(1, 3), batch(2, 4)
    assert not al._rescue_key(al.tls)[1]
    res = al.align_batch_arrays(b1, b2)
    assert res.get("rescue_skipped_count", 0) > 0
    b1.tls_hint = TlsStatic(min=200, max=400, mate_min=200, mate_max=400,
                            best0=1, best1=6, median=300)
    res = al.align_batch_arrays(b1, b2)
    assert res.get("rescue_skipped_count", 0) == 0
    sh = [i for i, r in enumerate(rows) if r[0].startswith("sh")]
    assert sh and res["aligned_2"][sh].all()
