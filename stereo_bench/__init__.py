"""The benchmark of ``ros_gpu_stereo_processor_tpu_torch``, the PyTorch + CUDA
stereo node, on one NVIDIA H100.

    python3 -m stereo_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once: a recorded stereo sequence
(seeded synthetic pairs at the configuration's geometry) replayed through
the node's served path (``StreamingIngest.feed`` from one producer thread,
``frames_prefetch``, the frame step, ``enqueue_send`` and the publishers)
for ``--seconds``, then checks a sample of the pairs published in the
window against the plain reference of this folder and prints one JSON
line.

Everything is found by name: a configuration is ``configs/<name>.json``, a
traffic mix ``traffic/<name>.json`` (read by the one generator,
``loop.py``), a per-layer metric ``metrics/<name>.py`` (a small reader of
the run's spans and device trace).  Nothing here imports JAX or the JAX
package, and the reference (``reference.py``) imports nothing of the port.
"""
