"""graphaligner_tpu — a batched, device-resident sequence-to-graph aligner.

A from-scratch JAX/XLA/Pallas re-design of the bit-parallel sequence-to-graph
aligner (reference: TankMermaid/GraphAligner, an early GraphAligner fork).
Its hot path runs on an NVIDIA GPU (the hand-written kernels are Pallas
lowered through Triton); the CPU backend runs the same program for tests.

Layer map (mirrors the reference's five layers):

  io/        serialization & I/O — GFA, vg protobuf wire codec, GAM streams,
             FASTQ/FASTA (reference L0: stream.hpp, vg.pb, fastqloader,
             GfaGraph, CommonUtils)
  graph/     graph preprocessing — bigraph→digraph doubling, the device-array
             AlignmentGraph index, SCC condensation (reference L1:
             BigraphToDigraph, AlignmentGraph)
  ops/       the compute kernels — emulated 64-bit word ops, Myers
             block-advance, WordSlice merge; jnp reference impls, the
             Pallas GPU kernels and the per-platform kernel choice
             (reference L2 inner loops: WordSlice.h, GraphAligner.h
             getNextSlice/mergeTwoSlices)
  core/      the alignment engine — batched slice DP, banding, correctness
             HMM, backtrace, seed-and-extend orchestration (reference L2:
             GraphAligner.h)
  parallel/  device mesh / multi-host sharding (no reference counterpart —
             the reference is single-process pthreads)
  runtime/   driver + CLI (reference L3: Aligner.cpp, AlignerMain.cpp)
  tools/     ecosystem tools (reference L4: SimulateReads, CompareAlignments,
             PickSeedHits, Bluntify, VisualizeAlignment, ...)

The key architectural translation: the reference packs 64 DP cells per CPU
word (Myers bit-parallelism). Here each 64-row word is a pair of uint32
lanes, and every word op is vectorized across a *batch* of alignment
problems on the device — 64×batch cells per vector op.
"""

import os

__version__ = "0.1.0"

# the persistent XLA compile cache, when JAX_COMPILATION_CACHE_DIR is unset
# (gitignored; fixed, so every run of this checkout finds it again)
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def _enable_persistent_compile_cache():
    """The engine compiles one executable per (batch, slice-count, band)
    shape bucket; the cache makes each a one-time cost per checkout, on
    every platform. JAX reads JAX_COMPILATION_CACHE_DIR itself, so the
    code sets a directory only when that variable is unset."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_persistent_compile_cache()
