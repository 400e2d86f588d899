"""The plain reference the benchmark judges the program by: plain PyTorch
in float32 (the caller turns TF32 off), independent of the program. It
imports neither JAX, nor the JAX package, nor anything of ``lvc_tpu_torch``.

Copied from the port at commit 7572f27 (so that the reference makes the
same discrete choices from the same numbers and draws the same sampling
priorities): box geometry, anchors, box coding, the NMS fixpoint, the
masked top-k, the matcher, the fixed-slot sampler and its per-image seeds
(``boxes.py``), and the paired RoIAlign's taps (``pool.py``). Written here:
the ResNet-FPN, the RPN head and losses, the proposal selection, the ROI
heads' sampling, box head, losses and post-processing (``model.py``), SGD
(``train.py``) and the seeded weights (``weights.py``), from detectron2's
description and the configuration's documented departures (see
``model.py``)."""
