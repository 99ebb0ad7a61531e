"""Port's single-end Aligner vs the JAX Aligner: golden SAM snapshot, SAM
records on an indel fixture, config parity, index conversion, and the
port running with jax unavailable."""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from isaac_aligner_tpu import aligner as jaligner
from isaac_aligner_tpu import dna
from isaac_aligner_tpu.align import gapped as jgapped
from isaac_aligner_tpu.align import pipeline as jpipe
from isaac_aligner_tpu.index.build import build_index
from isaac_aligner_tpu.io.fasta import genome_from_sequences
from isaac_aligner_tpu.io.fastq import ReadBatch
from isaac_aligner_tpu_torch.aligner import Aligner
from isaac_aligner_tpu_torch.align import gapped as tgapped
from isaac_aligner_tpu_torch.align import pipeline as tpipe
from isaac_aligner_tpu_torch.ops import sw

from test_golden_snapshot import GOLDEN_SE, _batch, _core, _fixture
from test_torch_host import to_port_index

REPO = Path(__file__).resolve().parents[1]


def test_single_end_golden():
    """tests/test_golden_snapshot.py::test_single_end_golden on the port."""
    genome, index = _fixture()
    L = 80
    g = genome.codes
    exact = g[2000:2080]
    snp = g[4000:4080].copy(); snp[40] = (snp[40] + 1) % 4
    rc = dna.revcomp(g[6000:6080])
    del5 = np.concatenate([g[8000:8030], g[8035:8085]])
    junk = dna.encode("".join("ACGT"[(7 * i + 3) % 4] for i in range(L)))
    batch = _batch([exact, snp, rc, del5, junk],
                   ["exact", "snp", "rc", "del5", "junk"])
    recs = Aligner.create(to_port_index(index), read_len=L,
                          base_quality_cutoff=0,
                          device="cpu").align_to_sam(batch)
    assert [_core(r) for r in recs] == GOLDEN_SE


def _indel_fixture():
    """64 reads of 100 bp on a unique 20 kbp genome: 4 with a short indel
    (banded-SW polish), 2 with a long deletion and 1 with a long
    insertion (long-indel polish), the rest with 1% substitutions; random
    qualities, a few low-quality tails."""
    rng = np.random.default_rng(21)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 20_000))
    genome = genome_from_sequences([("chrI", seq)])
    index = build_index(genome, seed_len=32)
    g = genome.codes
    rows, names = [], []
    for i in range(64):
        s = int(rng.integers(100, 19_700))
        if i < 4:              # short indel in the middle
            k = 3 + i
            if i % 2:
                r = np.concatenate([g[s:s + 50], g[s + 50 + k:s + 100 + k]])
            else:
                r = np.concatenate([g[s:s + 50], rng.integers(0, 4, k),
                                    g[s + 50:s + 100 - k]])
        elif i < 6:            # long deletion, beyond the SW band
            k = 25 + 10 * (i - 4)
            r = np.concatenate([g[s:s + 45], g[s + 45 + k:s + 100 + k]])
        elif i == 6:           # long insertion
            r = np.concatenate([g[s:s + 40], rng.integers(0, 4, 20),
                                g[s + 40:s + 80]])
        else:
            r = g[s:s + 100].copy()
            mut = rng.random(100) < 0.01
            r = np.where(mut, rng.integers(0, 4, 100), r)
        if i % 3 == 1:
            r = dna.revcomp(r)
        rows.append(np.asarray(r, np.uint8))
        names.append(f"r{i}")
    bases = np.stack(rows)
    quals = rng.integers(26, 41, bases.shape).astype(np.uint8)
    quals[10:14, -12:] = 5
    batch = ReadBatch(names=names, bases=bases, quals=quals,
                      lengths=np.full(64, 100, np.int32))
    return index, batch


def test_sam_records_equal_jax_aligner_on_indel_fixture():
    index, batch = _indel_fixture()
    want = jaligner.Aligner.create(index, read_len=100).align_to_sam(batch)
    before = sw.banded_sw.launches
    got = Aligner.create(to_port_index(index), read_len=100,
                         device="cpu").align_to_sam(batch)
    assert [r.to_line() for r in got] == [r.to_line() for r in want]
    cigars = [r.cigar for r in got]
    # the banded-SW polish found the short indels ...
    assert any(("I" in c or "D" in c) and len(c) < 14 for c in cigars[:4])
    # ... and the long-indel polish the gaps wider than the band
    assert any("35D" in c or "25D" in c for c in cigars[4:6])
    assert "20I" in cigars[6]
    assert sw.banded_sw.launches == before     # CPU: the plain version


def test_align_to_sam_many_in_order():
    index, batch = _indel_fixture()
    al = Aligner.create(to_port_index(index), read_len=100, device="cpu")
    halves = [ReadBatch(names=batch.names[a:b], bases=batch.bases[a:b],
                        quals=batch.quals[a:b], lengths=batch.lengths[a:b])
              for a, b in ((0, 32), (32, 64))]
    many = [r.to_line() for recs in al.align_to_sam_many(halves) for r in recs]
    one = [r.to_line() for h in halves for r in al.align_to_sam(h)]
    assert many == one
    assert al.finder_stats["seeds_no_match"] >= 0
    assert len(al.finder_stats["tally"]) == 4


def test_config_and_gap_scoring_match_jax():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(tpipe.AlignConfig) == fields(jpipe.AlignConfig)
    assert fields(tgapped.GapScoring) == fields(jgapped.GapScoring)
    assert tgapped.BWA == tgapped.GapScoring(**dataclasses.asdict(jgapped.BWA))
    assert dataclasses.asdict(tgapped.ELAND) == dataclasses.asdict(jgapped.ELAND)
    for spec in ("bwa", "eland", "1:-2:-7:-3", "1:-2:-7:-3:-9"):
        assert dataclasses.asdict(tgapped.GapScoring.parse(spec)) == \
            dataclasses.asdict(jgapped.GapScoring.parse(spec))
    assert tgapped.BWA.norm_open == jgapped.BWA.norm_open


def test_index_arrays_from_numpy_matches_prepare_index():
    from __graft_entry__ import _tiny_fixture
    index, bases, quals, cfg = _tiny_fixture()
    jarr = jpipe.prepare_index(index)
    d = {k: np.asarray(v) for k, v in jax.device_get(jarr._asdict()).items()
         if k != "key_mids"}
    converted = tpipe.index_arrays_from_numpy(d, "cpu")
    direct = tpipe.prepare_index(index, "cpu", upload_codes=True)
    for f in dataclasses.fields(tpipe.IndexArrays):
        a, b = getattr(converted, f.name), getattr(direct, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    tcfg = tpipe.AlignConfig(**dataclasses.asdict(cfg))
    tb, tq = torch.from_numpy(bases), torch.from_numpy(quals)
    for a, b in zip(tpipe.find_seed_hits(converted, tcfg, tb)[:4],
                    tpipe.find_seed_hits(direct, tcfg, tb)[:4]):
        assert torch.equal(a, b)
    out_c = tpipe.align_batch(converted, tb, tq, tcfg)
    out_d = tpipe.align_batch(direct, tb, tq, tcfg)
    for k in out_d:
        assert torch.equal(out_c[k], out_d[k]), k


def test_create_on_missing_card_raises():
    index = to_port_index(_fixture()[1])
    if torch.cuda.is_available():
        assert Aligner.create(index, read_len=80,
                              device="cuda").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            Aligner.create(index, read_len=80, device="cuda")
        with pytest.raises(RuntimeError, match="cuda"):  # the default
            Aligner.create(index, read_len=80)


def test_create_rejects_reads_over_kernel_limit_on_cuda():
    """The CUDA SW kernel's length limit shows at create, not at the first
    gapped polish; the CPU path has no such limit."""
    index = to_port_index(_fixture()[1])
    with pytest.raises(ValueError, match="MAX_LEN|longest read"):
        Aligner.create(index, read_len=sw.MAX_LEN + 1, device="cuda")
    assert Aligner.create(index, read_len=sw.MAX_LEN + 1,
                          device="cpu").device.type == "cpu"


def test_port_runs_without_jax(tmp_path):
    """What the GPU machine sees: neither jax nor the JAX package.  The
    library slice and the workflow (FASTQ -> sorted BAM, single-end and
    paired-end, with its spawned output process, which re-runs this
    script's top) run on cpu."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["isaac_aligner_tpu"] = None
        from pathlib import Path
        import numpy as np
        from isaac_aligner_tpu_torch.index.build import build_index
        from isaac_aligner_tpu_torch.io.bam import read_bam
        from isaac_aligner_tpu_torch.io.fastq import batch_from_reads
        from isaac_aligner_tpu_torch import synthetic
        from isaac_aligner_tpu_torch.aligner import Aligner
        from isaac_aligner_tpu_torch.workflow import output_proc
        from isaac_aligner_tpu_torch.workflow.align import (AlignWorkflow,
                                                            WorkflowOptions)


        def main(d):
            rng = np.random.default_rng(0)
            genome = synthetic.make_genome(rng, 20_000,
                                           families=((300, 3, 0.02),),
                                           n_island=(15_000, 100))
            index = build_index(genome, seed_len=32)
            sim = synthetic.make_reads(rng, genome.codes, 64, indel_frac=0.1)
            seqs = ["".join("ACGTN"[c] for c in r) for r in sim.bases]
            batch = batch_from_reads([f"r{i}" for i in range(64)], seqs,
                                     ["I" * 100] * 64)
            al = Aligner.create(index, read_len=100, device="cpu")
            recs = [r for recs in al.align_to_sam_many([batch]) for r in recs]
            mapped = sum(r.is_mapped for r in recs)
            assert mapped >= 56, mapped
            index.save(d / "idx")
            with open(d / "r1.fq", "w") as f:
                for i, s in enumerate(seqs):
                    f.write(f"@r{i}\\n{s}\\n+\\n{'I' * 100}\\n")
            assert output_proc.enabled()
            AlignWorkflow(WorkflowOptions(
                reference=str(d / "idx"), output_dir=str(d / "out"),
                fastq1=str(d / "r1.fq"), batch_size=32,
                device="cpu")).run()
            bam = read_bam(d / "out" / "sorted.bam")[2]
            assert len(bam) == 64
            assert sum(r.is_mapped for r in bam) == mapped
            sp = synthetic.make_pairs(rng, genome.codes, 48, far_frac=0.0,
                                      damaged_frac=0.1)
            for e, reads in ((1, sp.bases1), (2, sp.bases2)):
                with open(d / f"p{e}.fq", "w") as f:
                    for i, r in enumerate(reads):
                        s = "".join("ACGTN"[c] for c in r)
                        f.write(f"@t{i}\\n{s}\\n+\\n{'I' * 100}\\n")
            AlignWorkflow(WorkflowOptions(
                reference=str(d / "idx"), output_dir=str(d / "pe"),
                fastq1=str(d / "p1.fq"), fastq2=str(d / "p2.fq"),
                batch_size=32, device="cpu")).run()
            pe = read_bam(d / "pe" / "sorted.bam")[2]
            assert len(pe) == 96
            assert sum(r.flag & 0x2 != 0 for r in pe) >= 72
            loaded = {m.split(".")[0] for m in sys.modules
                      if sys.modules[m] is not None}
            assert not loaded & {"jax", "isaac_aligner_tpu"}, loaded
            print("OK", mapped)


        if __name__ == "__main__":
            main(Path(sys.argv[1]))
    """)
    (tmp_path / "run.py").write_text(script)
    proc = subprocess.run([sys.executable, str(tmp_path / "run.py"),
                           str(tmp_path)], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK" in proc.stdout
