"""The bench modules of the port (from the JAX package's bench.py and
scripts/bench_*.py): each runs one measured configuration with its
script's recipe and prints its script's JSON line, the keys renamed only
where a TPU-only field has a card counterpart (bench/common.py).

    python -m smoe_tpu_torch.bench.flagship       # bench.py
    python -m smoe_tpu_torch.bench.fit_1080p      # scripts/bench_1080p.py
    python -m smoe_tpu_torch.bench.fit_4k         # scripts/bench_4k.py
    python -m smoe_tpu_torch.bench.decode         # scripts/bench_decode.py
    python -m smoe_tpu_torch.bench.video          # scripts/bench_video.py
    python -m smoe_tpu_torch.bench.video_quality  # bench_video_quality.py
    python -m smoe_tpu_torch.bench.lf             # scripts/bench_lf.py

Each runs on the card unless `--device cpu` is given, and refuses a CUDA
device when there is no card (non-zero exit, no result line)."""
