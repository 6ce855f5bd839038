"""The generator: determinism per seed, and the same sizes for every
seed."""

import json
import os

import numpy as np

from gpubench import generate
from gpubench.tests.conftest import ROOT


def _cfg():
    with open(os.path.join(ROOT, "gpubench", "configs",
                           "gage-rsph.json")) as fh:
        cfg = json.load(fh)
    cfg["genome_bp"] = 400_000
    return cfg


def _stages(cfg, seed, n=3):
    g = generate.make_genome(cfg, seed, 7)
    return g, [generate.make_stage(cfg, g, 7, k) for k in range(n)]


def test_same_seed_same_problems():
    cfg = _cfg()
    g1, s1 = _stages(cfg, 2**31 + 11)
    g2, s2 = _stages(cfg, 2**31 + 11)
    assert np.array_equal(g1.master, g2.master)
    assert np.array_equal(g1.slave, g2.slave)
    for a, b in zip(s1, s2):
        assert a.round_cells == b.round_cells
        for ra, rb in zip(a.rounds, b.rounds):
            for pa, pb in zip(ra, rb):
                assert pa[1:3] == pb[1:3] and pa[4:] == pb[4:]
                assert np.array_equal(pa[0], pb[0])
                assert np.array_equal(pa[3], pb[3])


def test_other_seed_same_sizes_other_letters():
    cfg = _cfg()
    g1, s1 = _stages(cfg, 1)
    g2, s2 = _stages(cfg, 2**33 + 5)
    assert not np.array_equal(g1.master, g2.master)
    assert len(g1.slave) == len(g2.slave)
    for a, b in zip(s1, s2):
        assert a.round_cells == b.round_cells
        assert all(np.array_equal(x, y)
                   for x, y in zip(a.round_rows, b.round_rows))
    assert generate.stage_order(1, 29) != generate.stage_order(2, 29)
    assert sorted(generate.stage_order(1, 29)) == list(range(29))


def test_windows_follow_the_slave_copy():
    """Each window's slave rows are the master's stretch with the
    assemblies' differences: begin_b maps begin_a, and the window holds
    its stretch's length up to the indels inside it."""
    cfg = _cfg()
    g, stages = _stages(cfg, 5, 1)
    blk = cfg["blocks"]
    n = 0
    for rnd in stages[0].rounds:
        for a, ba, ea, b, bb, eb, fs, fe in rnd:
            assert not fs and not fe
            assert 0 <= ba <= ea < len(a) and 0 <= bb <= eb < len(b)
            assert blk["min_block_bp"] <= ea - ba + 1 <= blk["max_window_bp"]
            assert abs((eb - bb) - (ea - ba)) <= 64
            n += 1
    assert n > 10
    # the rounds are the chains' windows in turn: each round no larger
    # than the one before
    sizes = [len(r) for r in stages[0].rounds]
    assert sizes == sorted(sizes, reverse=True)


def test_rounds_are_the_ports_own_merge(tmp_path, one_thread):
    """The generator's rules against the program: the port's own create
    and merge (CPU), on contigs cut as a stage cuts them, with the read
    pairs over each repeat dropped (as create's multiplicity filter drops
    multi-mapped reads), send the same rounds of block windows as the
    stage, each window at most a read pair's span shorter."""
    import sys

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_problems as tp
    from gam_ngs_tpu_torch.models.create import CreateOptions, run_create
    from gam_ngs_tpu_torch.models.merge import MergeOptions, run_merge
    from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine

    cfg = _cfg()
    cfg["genome_bp"] = 90_000
    cfg["differences"] = dict(cfg["differences"], substitutions_per_kbp=0,
                              indels_per_kbp=0)
    # this lattice (a pair every 25 bp) holds create's 10 reads a block
    # in a stretch of 325 bp or more: the stage keeps such windows alone
    step = 25
    cfg["blocks"] = dict(cfg["blocks"], min_block_bp=tp.INSERT + 6 * step)
    g = generate.make_genome(cfg, 11, 7)
    st = generate.make_stage(cfg, g, 7, 0)
    rng = generate.rng_for(7, 1, 0)
    n = cfg["genome_bp"]
    mb = generate.contig_bounds(rng, n, cfg["master"]).tolist()
    sb = generate.contig_bounds(rng, n, cfg["slave"]).tolist()
    text = "".join(np.array(list("ACGT"))[g.master])
    m_recs, s_recs = [], []
    for k, p in enumerate(range(0, n - tp.INSERT, step)):
        q = p + tp.INSERT
        if ((g.repeats[:, 0] < q) & (p < g.repeats[:, 1])).any():
            continue
        for cuts, recs in ((mb, m_recs), (sb, s_recs)):
            c = int(np.searchsorted(cuts, p, side="right")) - 1
            if q <= cuts[c + 1]:
                recs += tp.pe_records(f"r{k}", text[p:p + tp.READ_LEN], c,
                                      p - cuts[c], text[q - tp.READ_LEN:q],
                                      c, q - tp.READ_LEN - cuts[c])

    def ctgs(cuts, tag):
        return [(f"{tag}{i}", text[cuts[i]:cuts[i + 1]])
                for i in range(len(cuts) - 1)]

    ml, sl, mfa, sfa = tp._write_inputs(tmp_path, ctgs(mb, "M"),
                                        ctgs(sb, "S"), m_recs, s_recs,
                                        {"m": "m", "s": "s"})
    run_create(CreateOptions(master_bam_file=ml, slave_bam_file=sl,
                             min_block_size=10, engine="oracle",
                             output_file_prefix=str(tmp_path / "out")),
               log=lambda *a: None)
    engine = BswEngine(torch.device("cpu"))
    sent = []
    real = engine.align_many

    def align_many(problems):
        sent.append(sorted(p[5] - p[4] + 1 for p in problems))
        return real(problems)

    engine.align_many = align_many
    run_merge(MergeOptions(master_bam_file=ml, slave_bam_file=sl,
                           blocks_file=str(tmp_path / "out.blocks"),
                           master_fasta_file=mfa, slave_fasta_file=sfa,
                           min_block_size=10, engine=engine,
                           output_file_prefix=str(tmp_path / "merged")),
              log=lambda *a: None)
    want = [sorted(rows.tolist()) for rows in st.round_rows]
    assert [len(r) for r in sent] == [len(r) for r in want], (sent, want)
    assert len(want) > 1
    for got, exp in zip(sent, want):
        gaps = np.asarray(exp) - np.asarray(got)
        assert ((gaps >= 0) & (gaps <= tp.INSERT)).all(), (got, exp)
