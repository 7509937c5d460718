"""Benchmark of readsb_tpu_torch's channel-batched demodulator on one card.

One run drives `readsb_tpu_torch.pipeline.MultiDemodulator.feed` over a
window of superblocks and checks what it returned against a plain
reference demodulator (`portbench.reference`).  A cell is found by name
in `BENCHMARK.json`; its configuration, traffic mix and per-layer
metrics are files of their own under `portbench/configs`,
`portbench/traffic` and `portbench/metrics`.

    python3 -m portbench.run --workload sc16nodf_quiet --seed 1 --seconds 51 --trace 0

Nothing here imports jax or the JAX package, and the reference imports
nothing of readsb_tpu_torch.
"""
