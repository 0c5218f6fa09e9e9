"""30kb reads through the batched pipeline vs reference goldens.

Exercises the larger compiled slice buckets (S=640) and the HBM-aware
chunk sizing. Runs only on a GPU — the CPU test backend would take
minutes per read:
  JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_giant_reads.py
"""

import pytest

from pathlib import Path

G = Path(__file__).parent / "fixtures" / "longsim" / "giant"


@pytest.mark.gpu
def test_giant_reads_match_reference(tmp_path):
    from graphaligner_tpu.core.params import AlignerParams
    from graphaligner_tpu.io import stream, vg
    from graphaligner_tpu.runtime.aligner import align_reads

    params = AlignerParams(
        graph_file=str(G.parent / "graph.vg"),
        fastq_file=str(G / "giant_reads.fastq"),
        alignment_file=str(tmp_path / "out.gam"),
        seed_file=str(G / "giant_seeds.gam"),
        initial_bandwidth=35,
    )
    align_reads(params, log=lambda m: None, output_dir=str(tmp_path), backend="jax")
    golden = stream.read_messages(str(G / "giant_out.gam"), vg.Alignment)
    mine = stream.read_messages(str(tmp_path / "out.gam"), vg.Alignment)
    assert [repr(a) for a in golden] == [repr(b) for b in mine]
