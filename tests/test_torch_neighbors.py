"""Port's neighbor annotation, index builds, `sort-reference` and index
tools vs the JAX package's, on the CPU: the device program against the JAX
one (single sort and partitioned) and the host oracle for 16/32/64-mers,
annotate_index and its bounded-RAM form, annotated and streaming builds,
index directories written by both CLIs byte-equal, the neighbor MAPQ
gating through the port's Aligner, and the five tool subcommands."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from isaac_aligner_tpu.cli import main as jcli
from isaac_aligner_tpu.index import build as jbuild
from isaac_aligner_tpu.index import neighbors as jnb
from isaac_aligner_tpu.index import neighbors_tpu as jnt
from isaac_aligner_tpu.io.fasta import genome_from_sequences
from isaac_aligner_tpu_torch import dna
from isaac_aligner_tpu_torch.aligner import Aligner
from isaac_aligner_tpu_torch.cli import main as tcli
from isaac_aligner_tpu_torch.index import build, neighbors, neighbors_device
from isaac_aligner_tpu_torch.io import fasta
from isaac_aligner_tpu_torch.io.fastq import batch_from_reads

from test_neighbors_tpu import _plant_neighbors_u64


def _planes(km: np.ndarray, k: int):
    if k == 32:
        return ((km >> np.uint64(32)).astype(np.uint32),
                (km & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (km.astype(np.uint32),)


def port_genome(g) -> fasta.Genome:
    return fasta.Genome(codes=g.codes.copy(),
                        contigs=[fasta.ContigMeta(**dataclasses.asdict(c))
                                 for c in g.contigs])


def near_repeat_genome(n: int = 12_000, seed: int = 41):
    """Random bases with a 300 bp region copied twice elsewhere, one copy
    with a substitution every 40th base (neighbors within 4 mismatches for
    every k), and a short N run; two contigs."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    region = codes[1_000:1_300].copy()
    codes[5_000:5_300] = region
    near = region.copy()
    near[::40] = (near[::40] + 1) % 4
    codes[8_000:8_300] = near
    codes[10_500:10_520] = 4
    s = dna.decode(codes)
    return genome_from_sequences([("cA", s[:7_000]), ("cB", s[7_000:])])


@pytest.mark.parametrize("k", [16, 32])
def test_device_program_equals_jax_and_host_oracle(k):
    rng = np.random.default_rng(17 + k)
    km = _plant_neighbors_u64(rng, 2500, k, 120)
    host = jnb.find_neighbors(km, k=k)
    want = jnt.find_neighbors_device(_planes(km, k), k)
    stats = {}
    got = neighbors_device.find_neighbors_device(_planes(km, k), k,
                                                 device="cpu", stats=stats)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(
        neighbors.find_neighbors(km, k=k), host)
    assert host.sum() > 50 and stats["max_run"] >= 2


def test_device_program_64mer_equals_brute_force_and_jax():
    rng = np.random.default_rng(29)
    w = rng.integers(0, 1 << 32, (300, 4), dtype=np.uint64).astype(np.uint32)
    for i in range(0, 80, 2):
        w[i + 1] = w[i]
        for _ in range(int(rng.integers(1, 5))):
            pos = int(rng.integers(0, 64))
            word, off = pos // 16, pos % 16
            w[i + 1, word] ^= (np.uint32(rng.integers(1, 4))
                               << np.uint32(2 * (15 - off)))
    w = np.unique(w, axis=0)
    bases = np.zeros((w.shape[0], 64), np.int64)
    for j in range(4):
        for b in range(16):
            bases[:, 16 * j + b] = (w[:, j] >> np.uint32(30 - 2 * b)) & 3
    mm = (bases[:, None, :] != bases[None, :, :]).sum(axis=2)
    want = ((mm <= 4) & (mm > 0)).any(axis=1)
    planes = tuple(w[:, j] for j in range(4))
    got = neighbors_device.find_neighbors_device(planes, 64, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnt.find_neighbors_device(planes, 64))
    assert want.sum() >= 40


def test_single_sort_equals_jax_partitioned_program(monkeypatch):
    """The JAX package splits large inputs by their first prefix block
    (a v5e workaround); forced small there, it must still equal the
    port's single sort."""
    monkeypatch.setattr(jnt, "DEVICE_SORT_MAX", 500)
    rng = np.random.default_rng(53)
    km = _plant_neighbors_u64(rng, 4000, 32, 250)
    want = jnt.find_neighbors_device(_planes(km, 32), 32)
    got = neighbors_device.find_neighbors_device(_planes(km, 32), 32,
                                                 device="cpu")
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 100


def test_routing_and_no_fallback():
    rng = np.random.default_rng(7)
    km = _plant_neighbors_u64(rng, 600, 32, 40)
    planes = _planes(km, 32)
    # an uncapped run_cap takes the host scan, as in the JAX package
    np.testing.assert_array_equal(
        neighbors_device.annotate_unique_auto(planes, 32, run_cap=1 << 30,
                                              device="cpu"),
        jnt.annotate_unique_auto(planes, 32, run_cap=1 << 30))
    assert neighbors_device.DEVICE_MAX_RECORDS == jnt.DEVICE_MAX_RECORDS
    # a device that fails raises: no quiet host run
    with pytest.raises((RuntimeError, ValueError)):
        neighbors_device.annotate_unique_auto(planes, 32, device="meta")


def _annot_fixture():
    rng = np.random.default_rng(3)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    seg = list(seq[100:164])
    seg[10] = "T" if seg[10] != "T" else "A"
    seg[40] = "C" if seg[40] != "C" else "G"
    return genome_from_sequences([("chrN", seq + "".join(seg))])


def test_annotate_index_and_chunked_equal_jax(tmp_path):
    jidx = jbuild.build_index(_annot_fixture(), seed_len=32)
    want = jnb.annotate_index(jidx.key_hi, jidx.key_lo, k=32)
    got = neighbors.annotate_index(jidx.key_hi, jidx.key_lo, k=32,
                                   device="cpu")
    np.testing.assert_array_equal(got, want)
    assert want.any()
    small = neighbors.annotate_index_chunked(
        jidx.key_hi, jidx.key_lo, k=32, chunk=257, work_dir=tmp_path,
        device="cpu")
    big = neighbors.annotate_index_chunked(
        jidx.key_hi, jidx.key_lo, k=32, chunk=257, mem_records=64,
        part_bits=3, out_path=tmp_path / "nb.npy", work_dir=tmp_path,
        device="cpu")
    jbig = jnb.annotate_index_chunked(
        jidx.key_hi, jidx.key_lo, k=32, chunk=257, mem_records=64,
        part_bits=3, out_path=tmp_path / "jnb.npy", work_dir=tmp_path)
    for x in (small, big):
        np.testing.assert_array_equal(np.asarray(x), want.astype(np.uint8))
    np.testing.assert_array_equal(np.asarray(big), np.asarray(jbig))


@pytest.mark.parametrize("k", [16, 32, 64])
def test_annotated_build_bits_equal_jax(k):
    g = near_repeat_genome()
    want = jbuild.build_index(g, seed_len=k, annotate_neighbors=True)
    got = build.build_index(port_genome(g), seed_len=k,
                            annotate_neighbors=True, device="cpu")
    assert got.has_neighbors.dtype == want.has_neighbors.dtype
    np.testing.assert_array_equal(got.has_neighbors, want.has_neighbors)
    np.testing.assert_array_equal(got.key_hi, want.key_hi)
    assert got.has_neighbors.sum() >= 100


def _dir_bytes(d: Path) -> dict:
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("k,mask_width", [(16, 1), (16, 3), (32, 1),
                                          (32, 3), (64, 1), (64, 3)])
def test_streaming_build_files_equal_jax(tmp_path, k, mask_width):
    g = near_repeat_genome(seed=43)
    annotate = k != 64
    jbuild.build_index_streaming(g, tmp_path / "j", seed_len=k,
                                 annotate_neighbors=annotate,
                                 mask_width=mask_width, work_dir=tmp_path)
    build.build_index_streaming(port_genome(g), tmp_path / "t", seed_len=k,
                                annotate_neighbors=annotate,
                                mask_width=mask_width, work_dir=tmp_path,
                                device="cpu")
    want = _dir_bytes(tmp_path / "j")
    assert _dir_bytes(tmp_path / "t") == want
    assert ("neighbors.npy" in want) == annotate


def _write_fasta(path: Path, g) -> Path:
    with open(path, "w") as f:
        for c in g.contigs:
            seq = dna.decode(g.codes[c.offset:c.end])
            f.write(f">{c.name}\n" + "\n".join(
                seq[i:i + 60] for i in range(0, len(seq), 60)) + "\n")
    return path


@pytest.fixture(scope="module")
def ref_fa(tmp_path_factory) -> Path:
    return _write_fasta(tmp_path_factory.mktemp("ref") / "ref.fa",
                        near_repeat_genome(seed=47))


@pytest.mark.parametrize("flags", [
    [], ["--streaming"], ["--dont-annotate"], ["-s", "64", "--dont-annotate"],
    ["--streaming", "--mask-width", "2", "-s", "16"],
    ["--group-limit", "8000"]],
    ids=["plain", "streaming", "dont_annotate", "s64", "streaming_s16",
         "grouped"])
def test_sort_reference_writes_the_jax_directory(ref_fa, tmp_path, flags):
    assert jcli(["sort-reference", "-g", str(ref_fa), "-o",
                 str(tmp_path / "j")] + flags) == 0
    assert tcli(["sort-reference", "-g", str(ref_fa), "-o",
                 str(tmp_path / "t"), "--device", "cpu"] + flags) == 0
    want = _dir_bytes(tmp_path / "j")
    assert _dir_bytes(tmp_path / "t") == want
    if "--dont-annotate" not in flags:
        assert any(name.endswith("neighbors.npy") for name in want)
    if "--group-limit" in flags:
        assert "multi-reference.json" in want


def test_sort_reference_refusals_match_jax(ref_fa, tmp_path):
    args = ["sort-reference", "-g", str(ref_fa), "--streaming", "-s", "64"]
    with pytest.raises(ValueError) as want:
        jcli(args + ["-o", str(tmp_path / "j")])
    with pytest.raises(ValueError) as got:
        tcli(args + ["-o", str(tmp_path / "t"), "--device", "cpu"])
    assert str(got.value) == str(want.value)
    # a contig over the group limit: the same message and exit code
    assert jcli(["sort-reference", "-g", str(ref_fa), "-o",
                 str(tmp_path / "j2"), "--group-limit", "5000"]) == 2
    assert tcli(["sort-reference", "-g", str(ref_fa), "-o",
                 str(tmp_path / "t2"), "--group-limit", "5000",
                 "--device", "cpu"]) == 2


def test_sort_reference_defaults_to_the_card(ref_fa, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli(["sort-reference", "-g", str(ref_fa), "-o", str(tmp_path / "t")])
    assert not (tmp_path / "t").exists()


def _mutate(s, positions):
    out = list(s)
    for p in positions:
        out[p] = "A" if out[p] != "A" else "G"
    return "".join(out)


def test_neighbor_mapq_gating_through_port_aligner():
    """Two near-identical regions: the exact seed finds one placement,
    the neighbor bit demotes its MAPQ; a unique read keeps its MAPQ."""
    rng = np.random.default_rng(3)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    region = seq[1000:1100]
    copy = _mutate(region, list(range(7, 100, 16)))
    genome = fasta.genome_from_sequences(
        [("chrN", seq[:2000] + copy + seq[2000:])])
    idx_nb = build.build_index(genome, seed_len=32, annotate_neighbors=True,
                               device="cpu")
    idx_plain = build.build_index(genome, seed_len=32)
    batch = batch_from_reads(["amb", "u"], [_mutate(region[:64], [40, 52]),
                                            seq[2500:2564]])
    rec_nb = Aligner.create(idx_nb, read_len=64,
                            device="cpu").align_to_sam(batch)
    rec_plain = Aligner.create(idx_plain, read_len=64,
                               device="cpu").align_to_sam(batch)
    assert rec_plain[0].is_mapped and rec_nb[0].is_mapped
    assert rec_plain[0].mapq > 0
    assert rec_nb[0].mapq == 0
    assert rec_nb[1].is_mapped and rec_nb[1].mapq >= 40


@pytest.fixture(scope="module")
def tool_indexes(tmp_path_factory):
    """Annotated index directories of two disjoint genomes, written by the
    port's sort-reference."""
    d = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(4)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 1200))
    ga = genome_from_sequences([("cN", seq[:600] + seq[100:160] + seq[600:])])
    gb = genome_from_sequences(
        [("cM", "".join("ACGT"[i] for i in rng.integers(0, 4, 900))),
         ("cL", "".join("ACGT"[i] for i in rng.integers(0, 4, 700)))])
    for name, g in (("a", ga), ("b", gb)):
        assert tcli(["sort-reference", "-g", str(_write_fasta(d / f"{name}.fa",
                                                              g)),
                     "-o", str(d / name), "--device", "cpu"]) == 0
    return d


@pytest.mark.parametrize("tool", ["extract-neighbors", "merge-references",
                                  "reorder-reference", "pack-reference"])
def test_index_tools_equal_jax(tool_indexes, tmp_path, tool):
    d = tool_indexes
    outs = {}
    for name, cli in (("j", jcli), ("t", tcli)):
        o = tmp_path / name
        o.mkdir()
        if tool == "extract-neighbors":
            args = ["-i", str(d / "a"), "-o", str(o / "bits.npy"),
                    "--wig", str(o / "n.wig")]
        elif tool == "merge-references":
            args = ["-i", str(d / "a"), "-i", str(d / "b"), "-o",
                    str(o / "m")]
        elif tool == "reorder-reference":
            args = ["-i", str(d / "b"), "-o", str(o / "r"), "--order",
                    "cL,cM"]
        else:
            args = ["-i", str(d / "a"), "-o", str(o / "a.tgz")]
        assert cli([tool] + args) == 0
        if tool == "pack-reference":
            # gzip headers carry a time: compare what the archive unpacks to
            # in either package
            for uname, ucli in (("ju", jcli), ("tu", tcli)):
                assert ucli(["unpack-reference", "-i", str(o / "a.tgz"),
                             "-o", str(o / uname)]) == 0
                assert _dir_bytes(o / uname) == _dir_bytes(d / "a")
        outs[name] = _dir_bytes(o)
    if tool == "pack-reference":
        outs = {k: {f: b for f, b in v.items() if not f.endswith(".tgz")}
                for k, v in outs.items()}
    assert outs["t"] == outs["j"]
    if tool == "extract-neighbors":
        assert np.unpackbits(np.load(tmp_path / "t" / "bits.npy")).sum() > 0
