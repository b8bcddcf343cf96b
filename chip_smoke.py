"""Drive the PyTorch/CUDA port once on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--profile-dir DIR]

Phases, each fatal on failure (no CPU path, no fallback):

1. require a CUDA device; print the card's name and power limit;
2. build the banded kernel (csrc/band.cu: ``band_rows_kernel``, the
   walk over the band's nonzeros row by row, for K1 on the deep-K-window
   layout, K5 on the uniform band and K6 on the flat ragged band), the
   fused Chebyshev kernels (csrc/cheby_fused.cu: ``cheby_conv_kernel``,
   one template whose tap is K2's conv or K3's weight gradient, each in
   2- and 3-stage rings),
   the BSR operators' row-sparse gather kernel (csrc/bsr.cu,
   ``bsr_rows_kernel``, launched as K4 by ``bsr_colstream`` and as
   K7/K8/K9 by ``bsr_csr``; it shares csrc/rows.cuh with
   ``band_rows_kernel``), the probes P1-P3 (csrc/probes.cu) and the int8
   conversions (csrc/quant.cu) from source, one nvcc each, and the host Graclus matcher
   (``native/graph_kernels.cpp``) with g++, all started together; print
   each kernel's
   registers and shared memory, and the tensor-core instructions
   (``HMMA``/``HGMMA``) in K2's and K3's SASS (``cuobjdump -sass``),
   which their bf16 instantiations must hold;
3. hold the banded kernel K1 against both its plain PyTorch versions,
   the window product (``banded_dkw_reference``) and the row walk
   (``banded_rows_reference``), on the real 50,176-node serving operator
   at C = 512, for L@x, the hop 2L@x - x0 and the adjoint hop
   2L@x - x0 + c, in int8 (bit-identical; no adjoint hop), bf16 (one
   bf16 ulp: all round an f32 accumulation of exact bf16 products,
   summed in another order) and f32 (atol 1e-4, another summation
   order); time each form beside phase 16's library time, the sparse
   bound (``sparse_roofline``) and the block format's work
   (``spmm_roofline``);
4. serve the bench's NodeClassifier (K=25, Fin=512, 16 classes) on
   city_graph(224, k=8) through compile_serving: 4 requests in bf16 and
   4 in int8, each with its own features; check 24 kernel launches per
   request, finite [50176, 16] logits, and the served logits against the
   same requests run through the plain version on the card (its int8
   conversions the plain expressions too); in int8 one quantisation and
   K dequantisations a conv and request (``csrc/quant.cu``, counted on
   ``quant.quantize_int8`` and ``quant.dequantize_int8``, reset just
   before the requests);
5. train the bench's deep NodeClassifier (K=25, Fin=512, hidden=[512],
   16 classes; bench.py:243-321) for 4 adam steps through
   train_node_classifier on label-correlated features: on the bf16
   operator as the bench does, and on the f32 operator with the keep
   probability 0.8 of experiments/node_classification.py; check 72
   kernel launches per step (3 L@x, 46 hops, 23 adjoint hops), a finite
   loss that falls, and one step's loss and gradients against the same
   step with every band product on the plain version (0 launches);
6. time per-request latency, ms per training step (kernel and plain
   version) and the kernel's ms per form beside the plain version's,
   with CUDA events after a warm-up;
7. hold the fused kernels K2 (the conv) and K3 (its weight gradient)
   against their plain versions at the bench's dense_fused shape (x and
   g [100, 976, 32], w [25, 32, 32] on the 976-node level-0 operator)
   and ChebNet layer 1's shape (x [100, 244, 32], w [25, 32, 64], g
   [100, 244, 64]) in f32 (1e-4 of the largest value) and bf16 (1e-2),
   and K2 also at layer 1's dx shape (g [100, 244, 64], W^T [25, 64,
   32]); time both by device work (``device_ms``) beside their bounds,
   and K3's fold of its per-rank partials alone; print each geometry,
   one CTA's shared memory and how many clusters the card holds at once
   (``conv_resources``), and fail unless the ring fits in 232,448 bytes
   and one cluster fits;
8. serve the paper's ChebNet (MNIST grid, F=[32, 64], K=[25, 25], p=[4,
   4], M=[512, 10]; nips2016/mnist.ipynb cells 14-17) on its coarsened
   operators through compile_serving: 4 requests of 100 synthetic digits,
   with f32 operators (the paper's) and with bf16 ones; check 1 K2 and
   0 K3 launches per request (layer 0, Fin = 1, takes the stacked path),
   finite [100, 10] logits, and the logits against the same requests
   through operators whose fused conv runs the plain versions; then
   serve the f32 model through compile_serving's defaults (int8=True):
   every dense operator quantized (QuantDenseLaplacian), 4 requests
   with 0 K2 and 0 K3 launches, finite logits equal to the same int8
   serving on the CPU within 1e-4 of their max (the CPU path is held
   to JAX's int8 ChebNet by tests/test_torch_chebnet.py), the int8 K=25
   ``cheby_finals`` chain on the level-0 twin bit-identical on the card
   and on the CPU, and the argmax agreement with the f32 logits within
   0.005 of JAX's int8 ChebNet's on the same weights and requests;
9. train that ChebNet (dropout 0.5, L2 5e-4) for 4 adam steps through
   train_classifier on one fixed batch of 100, with f32 and bf16
   operators; check 2 K2 and 1 K3 launches per step, a finite loss that
   falls, and one step's loss and gradients against the plain twin with
   the same dropout seed; time requests and steps beside the twin's;
10. on the bench's 50k scattered kNN graph (bench.py:763-787: 50,000
   Gaussian points in 8-D, seed 0, k=10, RCM, normalized Laplacian),
   built by ``device_laplacian(fmt="auto")``, which must give the
   column-streamed BSR operator: hold K4 (``bsr_colstream``, the row
   kernel of csrc/bsr.cu) against its plain version
   (``bsr_rows_reference``, the same row walk) and the block walk's plain
   version
   (``bsr_colstream_reference``) at C = 512 for L@x and the hop in f32
   (atol 1e-4 of the max), bf16 (one bf16 ulp) and int8 (bit-identical),
   and time all three, each time printed beside phase 16's library time,
   the sparse bound (``sparse_roofline``) and the block format's work
   (``spmm_roofline``); then the same checks, through K4 and K7, on a
   graph with a row of 300 nonzeros (``hub_graph``);
11. serve the bench's NodeClassifier on it (4 requests in bf16, 4 in
   int8, features labelled by node index as bench.py:699-704 makes
   them): 24 K4 launches per request, finite [50000, 16] logits, the
   logits against the plain twin's; train the deep one (hidden=[512]) on
   the bf16 operator for 4 adam steps: 72 K4 launches per step (26 L@x,
   46 hops), a falling loss, one step against the plain twin; time
   requests and steps beside the twin's;
12. hold ``bsr_csr`` (the same row kernel) against both plain versions,
   as phase 10 does, through each route it ports: K8 on the scattered
   graph's ``col_stream=False`` operator (f32 and bf16 L@x), K7 int8 on
   that operator's int8 twin (G = 1, L@x and hop), K9 on its
   ``chunked_rows=True`` operator (f32 and bf16 L@x) and K7 float with
   G > 1 on the 50k city graph's ``fmt="bsr", col_stream=False`` bf16
   operator (L@x and hop); then serve
   one request through each route's operator: 24 launches of that route
   each, logits against the plain twin's;
13. on the 50k city graph at C = 512, hold K5 (the ``ragged=False``
   operator) and K6 (the ragged operator built with ``use_pallas=False``
   and then given it, quantized before for int8) against both plain
   versions, as phase 3, for
   L@x, the hop and (float) the adjoint hop in f32, bf16 and int8,
   tolerances as phase 3, and time them as phase 3 does; check the
   in-place hop (``donate``) of K1, K5 and K6 bit-identical to the
   out-of-place one and written into x0's storage, and time the two;
14. run bench.py's K=25 chains (bench.py:423-612): ``cheby_finals`` in a
   loop of K-blocks with the bf16 renormalisation, and int8 carries on
   the quantized operator, timed by ``utils.profiling.slope_time``, on
   the 50k graph in each layout (dkw -> K1, ragged -> K6, uniform ->
   K5) and on ``city_graph(316, k=8)`` (~100k nodes) in the default
   layout; check K-1 launches per K-block, the int8 chain bit-identical
   to the plain chain's and bf16 within 2e-2 of its max; print us per
   SpMM, Gedges/s, the roofline and the plain chain's time; the 100k
   operator is freed after;
15. serve the bench's NodeClassifier on the uniform operator in bf16 and
   int8 (4 requests each, 24 K5 launches per request, logits against
   the plain twin's), train the deep one on it in bf16 (4 adam steps, 72
   K5 launches per step, one step against the plain twin), and serve one
   bf16 and one int8 request through the ragged operator (24 K6
   launches each);
16. time the library call for each sparse product: one
   ``torch.sparse.mm`` of the same matrix in CSR at C = 512 on the card
   (50k city graph and 50k scattered graph; f32 and bf16; torch has no
   int8 one), beside the kernels' bounds; the city graph's before phase
   3 and the scattered graph's first thing in phase 10, so that phases
   3, 10, 12 and 13 print it beside their kernels' times;
17. with ``--profile-dir DIR`` only: trace 3 requests per serving mode
   after 2 warm-ups (banded, scattered BSR, ChebNet, uniform, ragged),
   2 bf16 training steps after one (banded, scattered and uniform
   NodeClassifier), 2 f32 ChebNet training steps after one, and 3
   library calls after one, with ``torch.profiler`` (CPU and CUDA
   activities); print the device time per request or step, its share
   of the measured time, the largest device kernels and aten ops, and
   for training the device time by part (K1, K5 or K4 by form, taps,
   dW, injections, casts, adam; K2 forward, K2 dx, K3, K3's fold, the
   stacked basis of ChebNet's layer 0, fc, adam), and the same for 2
   steps of phase 19's Trainer (its optimizer chain for adam) and of
   phase 22's ResGNN Trainer step (K2 forward and dx, K3, the stacked
   init and output convs); write each
   ``key_averages()`` table
   to ``DIR/profile_<mode>.txt``;
18. the probes (utils/probes.py, csrc/probes.cu): hold P1 (``mxu_probe``)
   at every geometry of experiments/_probe.py main_mxu, P2
   (``pred_probe``) in every variant of main_pred and P3
   (``loopcost_probe``) at unroll 1, 2, 4 and 8 against their plain
   versions on seeded operands (bf16 P1/P2 ones scaled by
   ``probes.CHECK_SCALE``, so that a dropped carry shows), two
   replicas, after 1 and 3 iterations (P3: 64 dots a call, 1 and 3
   chained calls): int8 bit-identical, bf16 within one bf16 ulp after
   1 and 2e-2 of the max after 3 (``probes.compare``); then time
   cuBLAS's chained products (the ``peak`` rows) and each probe at one replica and at enough replicas
   for two CTAs per SM, with its launches counted, and print each rate
   with its share of the data sheet's peak and of the measured cuBLAS
   peak.

19. train through ``Trainer.fit`` (``train/trainer.py``): (a) the paper's
   ChebNet of phase 8 (f32 operators, K2 and K3) with
   experiments/mnist.py's configuration (lr 1e-3, decay 0.95 each epoch,
   staircase) for 60 steps of 100 synthetic digits, an evaluation of 250
   every 20 steps, checkpoints and the JSONL stream in a temporary
   directory: check 2 K2 and 1 K3 launches per step and 2 K2 per
   evaluated batch (prediction and loss) over the whole fit, the JSONL
   lines, a finite EMA that falls, a second Trainer that resumes at step
   60 with equal parameters and runs nothing, and ``evaluate``/
   ``predict`` with a ragged last batch against ``apply``; print ms per
   step from fit's ``t_step`` and from CUDA events beside phase 9's; (b)
   ``experiments/text20news.py --synthetic`` (GC32, Fin = 1: the stacked
   route, no kernel) for 2 epochs: its test accuracy and step time;
20. the 20NEWS topology cell (bench.py:619-741): 4,000 synthetic
   documents, the 10,000 most frequent words, 64-D PPMI-SVD embeddings,
   16-NN (``algorithm="auto"``), RCM, normalized Laplacian; check that
   ``device_laplacian(fmt="auto", dtype=bf16)`` gives a 10,000-node
   ``DenseLaplacian``; run the K=5 ``cheby_finals`` chains (bf16 with the
   renormalisation, against the same chain in f32 on the f32 copy of
   the matrix within 2e-2 of its max; int8 through ``quantize_dense``'s
   int32 ``_int_mm``, bit-identical to the float64 accumulator it
   replaced), each timed by ``slope_time`` over 4 and 32 K-blocks, the
   float64 one too; train the planted-partition NodeClassifier (64
   features, 8 classes, K=5) 80 adam steps on the bf16 operator and
   check its float test accuracy at least 0.9 and the int8 one within
   0.01 of it;
21. right after phase 11, on its bf16 BSR operator: bench.py's 50k
   scattered K=25 chain (:764-826) in bf16 and int8 (``quantize_block_
   sparse(sample_x=3.0)``), timed over 2 and 6 K-blocks: check K-1 K4
   launches per K-block, int8 bit-identical to the plain twin's chain
   and bf16 within 2e-2 of its max; print us per SpMM, ns per block,
   Gedges/s and the sparse bound beside phase 16's ``torch.sparse.mm``.

22. flow forecasting on 1,024 regions (TaxiBJ's 32 x 32 Beijing grid,
   which the fork's bj loaders read): ``synthetic_flow(n_nodes=1024,
   n_steps=1400, seed=0)`` written as experiments/humanflow.py's
   ``build_dataset`` writes it and loaded by ``HumanTraffic.
   load_ln_data_period(4, 1, 1)`` (train [672, 1024, 12]); check that
   ``device_laplacian`` gives a 1,024-node f32 ``DenseLaplacian``, built
   with ``use_pallas=True`` (the fused conv is opt-in, as in JAX; the
   humanflow.py's default operator takes the stacked route, timed
   beside).
   (a) ResGNN (K=2, nfilter 64, nres 4) through ``Trainer(task=
   "regression").fit`` for 2 epochs (26 steps) at batch 50, lr 1e-3,
   decay 0.95: 16 K2 and 8 K3 launches per step and 16 K2 per evaluated
   batch (8 a forward), one step's loss and gradients against the plain
   twin within 1e-3 of their max, a finite EMA that falls, ``evaluate``
   with RMSE and MAPE after ``reverse_normalize``, ms per step by CUDA
   events and ``fit``'s ``t_step``; (b) ``GConvForecaster``
   glstm_gconv (H 64, K=2, its gLSTM dropout 0.8) for 10 steps: the
   gates' h-conv is K2 at (64 -> 256), its dx at (256 -> 64) and its dW
   K3 at (64, 256): 25 K2 and 13 K3 launches per step, the same checks;
   (c) ResGNN with the Fourier filter and the per-node LSTM
   (``load_lstm_data``), no kernel: 4 steps each, finite losses, ms per
   step;
23. K2 and K3 at those geometries on the 1,024-region operator, B = 50,
   K = 2, in f32 (1e-4 of the largest value) and bf16 (1e-2) against
   their plain versions: K2 (64 -> 64), (64 -> 256), (256 -> 64),
   (64 -> 32), (32 -> 32); K3 (64, 64), (64, 256), (32, 32); each timed
   by device work beside ``dense_cheby_bound`` and printed with its
   geometry (``np``, ``nop``, samples a group, clusters, rows, shared
   memory, clusters at once), failing where the ring or a cluster does
   not fit;
24. (a) the paper's other filters: ChebNet with ``filter="fourier"``,
   ``"spline"`` and ``"lanczos"`` on phase 7's MNIST-grid operators as
   experiments/mnist.py builds it, 8 adam steps each on one batch of 100
   (finite losses, the last under the first, the evaluation loss
   falling; no kernel launch) and one step against the CPU's; (b)
   ``lanczos_conv`` at K=5, B=2, Fin=16 on the f32 copy of phase 3's
   50,176-node deep-K-window operator: 5 K1 launches per call, the basis
   within 1e-3 of the plain operator's max;
25. the serving artifact (``serve.export_serving``/``load_serving``,
   the kernels as the custom ops of ``ops/library.py``): (a) right after
   phase 6, phase 4's int8 model (the bench's 50k request: K=25,
   Fin=512, 16 classes, dkw) exported, then loaded and served in a
   fresh ``python3`` that only runs ``python -m cnn_graph_tpu_torch.
   serve`` on the artifact and phase 4's int8 requests (written as
   ``.npy``): logits bit-identical to ``CompiledServing``'s, 24 K1
   launches per request and no other, the load seconds, and the loaded
   and compiled latencies (CUDA events); the same artifact loaded in
   this process, and one request of each handle's device kernels by
   name, where they differ; (b) loaded in this process, after phase 11
   the scattered NodeClassifier's int8 artifact (24 K4 launches a
   request, bit-identical) and after phases 8-9 the f32 ChebNet's on
   the fused operator (1 K2 launch a request, within 1e-6 of the max),
   each against its ``CompiledServing`` with the same launches; (c)
   after phase 20, the node-classification driver (``python -m
   cnn_graph_tpu_torch.experiments.node_classification --int8 --export
   DIR``: 100,000 nodes, K=3, hidden 64, 200 steps), its test accuracy
   above 0.5 and the int8 one within 0.05; its artifact loaded and
   served on the driver's own features: 4 K1 launches, and the int8
   test accuracy the driver printed.

26. the node-sharded operators (``cnn_graph_tpu_torch/parallel``), K1,
   K5 and K6 on halo-extended x, after phase 25 (c): (a) in this
   process, a world of one rank over NCCL (``experiments.multichip.
   one_rank_mesh``, a ``file://`` rendezvous):
   ``banded_halo_laplacian`` of the 50k city graph on a ``nodes=1``
   mesh in bf16 and int8, with and without ``force_boundary`` (the
   prefix, interior and suffix passes): L@x, the hop and the K=25
   chain against phase 3's single-chip operator, bf16 within one ulp
   and int8 bit-identical, each hop 1 K1 launch a region and no other
   kernel; then the multichip experiment's ``wrapper`` and ``chain`` modes
   (``multichip.one_rank_times``, ``slope_time``): the chain's us per
   SpMM hop by hop and through ``cheby_chain``, beside the single-chip
   chain's and phase 14's;
   (b) 4 ranks on the card over gloo (``torch.distributed.run``), the
   same graph sharded 4 ways, C = 512: each rank's rows of L@x, the hop
   and the K=25 chain on K1 (f32 within 1e-5 of the max, bf16 one ulp,
   int8 bit-identical) and of the chain's adjoint (1e-4) against the
   single-chip operator's, K5 on the uniform operator and K6 on the
   ragged one without the dkw twin (L@x and the hop), each kernel also
   against the row walk's plain version on the same halo-extended x;
   launches per rank, halo bytes per hop beside (h_l + h_r)*128*C*
   itemsize and the exchange's ms (gloo on one card); (c) the
   node-classification driver on 4 ranks (``--mesh-nodes 4 --halo banded
   --int8`` at its defaults but 100 training steps): test
   accuracy within 0.01 of phase 25 (c)'s, int8 within 0.05 of its float one, the K1 launches per step
   of every rank; (d) ``Trainer.fit`` with ``TrainConfig(mesh=
   make_mesh(data=2, nodes=2))`` on 4 ranks, phase 22's ResGNN on the
   dense halo operator, 4 steps: the parameters within 1e-4 of a
   one-process fit with the same config and data.  A rank that fails
   fails the run.

27. the sparse halo operators (``parallel/sparse_halo.py``), K8 (the
   BSR row kernel through ``bsr_csr``) and K5 on halo-extended x, and
   the BCOO format, after phase 26, on 4 ranks sharing the card over
   gloo: (a) the 50k city graph in ``fmt="bsr"`` and ``"banded"``: each
   rank's rows of L@x, the hop and the K=25 chain in f32, bf16 and int8
   against the single-chip banded operator's (f32 1e-5 of the max; bf16
   L@x and the fused hop one ulp, the BSR format's unfused hop, JAX's,
   one ulp of its operands against the unfused single-chip hop, the
   chain no farther from the f32 chain than twice the single-chip bf16
   chain; int8 bit-identical, the band scale equal), K+1 launches of the
   format's kernel and no other, the kernel against its plain version
   on the rank's extended x, the f32 adjoint (1e-4), H, the bytes of a
   bf16 exchange beside n*H*C*2 and its ms (gloo, one card); (b) the
   bench's 50k scattered graph in ``fmt="bsr"``, bf16 and int8, L@x and
   the hop against the single-chip BSR operator's rows, taken in this
   process while phase 10's operator exists (int8 bit-identical, bf16
   as in (a)), the blocks per rank; then, in the same world, (d)
   ``parallel.dryrun.dryrun_multichip``'s three parts; (c) the node-classification driver at its defaults with
   ``--mesh-nodes 4 --int8``, ``--halo sparse`` and ``--halo
   sparse-banded``: test accuracy within 0.01 of phase 25 (c)'s, int8
   within 0.05, K8 or K5 launches every step on every rank; (e) one NodeClassifier request on a ``fmt="bcoo"``
   operator (``torch.sparse.mm``, no kernel) within 1e-4 of the max of
   the f32 banded operator's logits on the same weights.

28. the banded operators at block shapes other than 128x128 and the
   native Graclus matcher, after phase 27: (a) K1, K5 and K6 in int8,
   bf16 and f32 against both plain versions in every form (L@x, the
   hop, +c, in place; phase 3's tolerances, int8 bit-identical) and
   timed beside the 128x128 kernel on the same graph and the sparse
   bound: on the 50k city graph at 64x64 and 32x32, C = 512, and on
   ``city_graph(40)`` at 8x8, 16x16, (32, 64), (64, 32), (24, 40) and
   128x128;
   (b) phases 3-5's NodeClassifier on the 50k operator at 64x64: 4
   requests each in bf16 and int8 through K1 (24 launches a request;
   int8 bit-identical to the plain twin), the logits against phase 4's
   128x128 ones (expected equal: the walk's sums do not depend on the
   block), one request each through K5 and K6, one deep bf16 training
   step (72 K1 launches) against the plain version, and the int8
   artifact exported and loaded in this process (bit-identical); (c) in
   phase 27's world, the sparse-halo banded shard at 64x64 on 4 ranks
   against the single-chip 64x64 operator (int8 bit-identical); (d)
   Graclus over 4 levels on the MNIST grid and the 50k city graph's
   8-NN adjacency with the native matcher (``cnn_graph_tpu_torch.
   native``, built with g++ in phase 2) and the Python loop: equal
   clusters, the seconds of each.

29. the int8 twins' activation conversions (``csrc/quant.cu``:
   ``quant_kernel``, ``dequant_kernel``), right after phase 6, at the 50k
   request's carries (50,176 x 512): ``quant.quantize_int8`` from f32 and
   bf16 and ``quant.dequantize_int8`` to f32 and bf16, each with a
   device scale (a 0-d f32 tensor, as the int8 convs pass it) and a
   Python float (the operator's ``act_scale``), bit-equal
   (``torch.equal``) to ``quant.quantize_reference`` /
   ``dequantize_reference`` called directly, one launch a call, values
   past +-127 included; each timed by device work beside the plain
   expression, the bytes bound at 3.35 TB/s and, for the
   dequantisation, the one library call of the same bits,
   ``torch.mul(q, s)``.

Each 50k scattered operator is freed after its phase.

The last three lines are the kernel record as one JSON object (each
kernel with its launches on the main path, its time and its plain
version's, its bound on the card and the library call's time), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cnn_graph_tpu_torch import _build, graphs, native  # noqa: E402
from cnn_graph_tpu_torch.data import (  # noqa: E402
    HumanTraffic,
    mnist_graph_data,
    synthetic_mnist,
    synthetic_text_dataset,
)
from cnn_graph_tpu_torch.experiments import (  # noqa: E402
    humanflow,
    multichip,
    node_classification,
    text20news,
)
from cnn_graph_tpu_torch.graphs import coarsening  # noqa: E402
from cnn_graph_tpu_torch.models import (  # noqa: E402
    ChebNet,
    GConvForecaster,
    NodeClassifier,
    PerNodeLSTM,
    ResGNN,
    stack_lstm_collection,
)
from cnn_graph_tpu_torch.models.common import (  # noqa: E402
    map_operators,
    tree_leaves,
    tree_map,
)
from cnn_graph_tpu_torch.ops import (  # noqa: E402
    BandedLaplacian,
    BlockSparseLaplacian,
    DenseLaplacian,
    QuantBandedLaplacian,
    QuantBlockSparseLaplacian,
    QuantDenseLaplacian,
    banded_dkw,
    banded_ragged,
    banded_rows_reference,
    banded_uniform,
    bsr_colstream,
    bsr_colstream_reference,
    bsr_csr,
    bsr_csr_reference,
    bsr_rows_reference,
    cheby_conv,
    cheby_conv_fused,
    cheby_conv_fused_reference,
    cheby_dw_fused,
    cheby_dw_fused_reference,
    cheby_finals,
    conv_geometry,
    conv_resources,
    device_laplacian,
    fused_filter,
    lanczos_basis_device,
    lanczos_conv,
    packing,
    quantize_banded,
    quantize_block_sparse,
    quantize_dense,
)
from cnn_graph_tpu_torch.ops import library, quant  # noqa: E402
from cnn_graph_tpu_torch.ops.band import layout_call  # noqa: E402
from cnn_graph_tpu_torch.ops.cheby import (  # noqa: E402
    _fold_dw_partials,
    _launch_dw,
)
from cnn_graph_tpu_torch.parallel import (  # noqa: E402
    banded_halo_laplacian,
    halo_sharded_laplacian,
    init_distributed,
    make_mesh,
    quantize_banded_halo,
    quantize_sparse_halo,
    sparse_halo_laplacian,
)
from cnn_graph_tpu_torch.parallel.dryrun import (  # noqa: E402
    dryrun_multichip,
)
from cnn_graph_tpu_torch.serve import (  # noqa: E402
    compile_serving,
    export_serving,
    load_serving,
)
from cnn_graph_tpu_torch.train import (  # noqa: E402
    TrainConfig,
    Trainer,
    train_classifier,
    train_node_classifier,
)
from cnn_graph_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager,
)
from cnn_graph_tpu_torch.utils import (  # noqa: E402
    probes,
    profiling,
    roofline,
    slope_time,
    sparse_roofline,
    spmm_roofline,
)
from cnn_graph_tpu_torch.utils.metrics import mape, rmse  # noqa: E402

SIDE, KNN, FIN, CLASSES, K = 224, 8, 512, 16, 25
N_REQUESTS = 4  # per serving mode
TRAIN_STEPS, LEARNING_RATE = 4, 1e-3  # per training mode; bench.py:268
# Kernel launches per training step of the deep model: each layer's
# forward runs 1 L@x and K-2 hops; layer 1's backward (layer 0 has no
# input gradient) K-2 adjoint hops and 1 L@x.
STEP_FORMS = {"spmm": 3, "hop": 2 * (K - 2), "hop_c": K - 2}
SOURCE = "cnn_graph_tpu_torch/csrc/band.cu"
# The banded kernels by layout, and the TPU kernel each replaces.
LAYOUT_KERNELS = {"dkw": banded_dkw, "uniform": banded_uniform,
                  "ragged": banded_ragged}
REPLACES = {"dkw": "cnn_graph_tpu/ops/pallas_band.py:448",      # K1
            "uniform": "cnn_graph_tpu/ops/pallas_band.py:70",   # K5
            "ragged": "cnn_graph_tpu/ops/pallas_band.py:202"}   # K6
KERNEL_ID = {"dkw": "K1", "uniform": "K5", "ragged": "K6"}
# The kernel of csrc/band.cu each layout launches.
BAND_KERNEL = {lay: "band_rows_kernel" for lay in LAYOUT_KERNELS}
# bench.py's chains: the 100k city graph (bench.py:555) and the K-blocks
# slope_time differences (bench.py:401).
SIDE_100K, CHAIN_UNITS = 316, (2, 8)
PLAIN_CHAIN_UNITS = (1, 3)  # the plain chain's K-blocks take ~0.1-0.2 s
# The paper's MNIST ChebNet (nips2016/mnist.ipynb cells 14-17,
# experiments/mnist.py:66-75): 4 coarsening levels from seed 2017.
CHEB = dict(F=[32, 64], K=[25, 25], p=[4, 4], M=[512, 10], dropout=0.5,
            regularization=5e-4)
CHEB_B, CHEB_SEED = 100, 2017
# The share of phase 8's 400 requests on which the int8 ChebNet's argmax
# equals the f32 one's, as JAX's quantize_model_operators ChebNet gives
# it on the same seeded weights and requests (tests/test_torch_chebnet.py
# test_phase8_int8_agreement_matches_jax, on the CPU): 347 of 400.
CHEB_INT8_AGREEMENT = 0.8675
CHEB_SOURCE = "cnn_graph_tpu_torch/csrc/cheby_fused.cu"
CHEB_REPLACES = {"K2": "cnn_graph_tpu/ops/pallas_cheby.py:61",    # _kernel
                 "K3": "cnn_graph_tpu/ops/pallas_cheby.py:210"}  # _dw_kernel
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# The bench's 50k scattered kNN graph (bench.py:763-787) and its kernels.
SCAT_N, SCAT_DIMS, SCAT_K = 50000, 8, 10
BSR_SOURCE = "cnn_graph_tpu_torch/csrc/bsr.cu"
BSR_KERNEL = "bsr_rows"  # csrc/bsr.cu bsr_rows_kernel, for K4 and K7-K9
BSR_REPLACES = {"K4": "cnn_graph_tpu/ops/pallas_spmm.py:129",  # colstream
                "K7": "cnn_graph_tpu/ops/pallas_spmm.py:35",   # grouped
                "K8": "cnn_graph_tpu/ops/pallas_spmm.py:450",  # _kernel
                "K9": "cnn_graph_tpu/ops/pallas_spmm.py:502"}  # chunked
# K4 launches per step of the deep model on BSR: each layer's forward
# 1 L@x and K-2 hops; layer 1's backward K-1 L@x (one per hop and one
# for its L@x); layer 0's features need no gradient.
BSR_STEP_FORMS = {"spmm": 2 + (K - 1), "hop": 2 * (K - 2)}
# Phase 19: the Trainer with experiments/mnist.py's configuration (lr
# 1e-3, decay 0.95 every epoch, staircase) on the paper's ChebNet: 2
# epochs of 3,000 digits in batches of 100 (60 steps), an evaluation
# every 20 steps on 250 digits and a test set of 250 (both end in a
# ragged batch); then the GC32 text driver for 2 epochs.
TRAINER_N, TRAINER_EPOCHS, TRAINER_EVAL, TRAINER_HELD = 3000, 2, 20, 250
TEXT_EPOCHS = 2
# Phase 20: the 20NEWS topology cell (bench.py:619-741): 4,000 synthetic
# documents over 12,000 words, the 10,000 most frequent kept, 64-D
# embeddings, 16-NN; K=5 chains at C = 512 over 4 and 32 K-blocks; the
# planted-partition NodeClassifier (64 features, 8 classes) trained 80
# adam steps at lr 1e-2.
NEWS_DOCS, NEWS_VOCAB, NEWS_WORDS, NEWS_DIM, NEWS_KNN = 4000, 12000, \
    10000, 64, 16
NEWS_K, NEWS_UNITS = 5, (4, 32)
NEWS_CLASSES, NEWS_FIN, NEWS_STEPS, NEWS_LR = 8, 64, 80, 1e-2
NEWS_JAX_NNZ = 271470  # the JAX package's graph (BENCH_LAST_GOOD.json)
# Phase 21: the 50k scattered K=25 chain on BSR (bench.py:764-826), over
# 2 and 6 K-blocks.
SCAT_CHAIN_UNITS = (2, 6)
# Phase 22: flow forecasting on TaxiBJ's 32 x 32 Beijing region grid
# (Zhang et al., AAAI 2017; the fork's bj loaders, humantraffic.py
# :290-349): experiments/humanflow.py's synthetic data at 1,024 regions
# and 1,400 half-hour steps, 4 closeness steps and one period and one
# trend step (12 channels), batch 50, lr 1e-3.
FLOW_NODES, FLOW_STEPS, FLOW_SEED, FLOW_SEQ = 1024, 1400, 0, 4
FLOW_B, FLOW_LR = 50, 1e-3
# humanflow.py's ResGNN (K=2, nfilter 64, nres 4), 2 epochs (26 steps); per
# training step on the fused operator its 8 residual convs (64 -> 64) run
# K2 forward and for dx, and K3: (16, 8); 8 K2 a forward.
RESGNN = dict(K=2, nfilter=64, nres_layer_count=4)
RESGNN_EPOCHS, RESGNN_STEP_LAUNCHES, RESGNN_FWD_K2 = 2, (16, 8), 8
# glstm_gconv (H 64, Hc 32, 4 conv blocks), 10 steps: per forward the
# h-conv (64 -> 256) on each of the 4 steps and the conv stack's 9 convs
# (64 -> 32, 8 x (32, 32)) run K2 (13); the backward runs K2 for dx on 3
# h-convs (the first step's h is the zero state, no gradient) and on the
# 9 stack convs, and K3 for all 13: (25, 13) a step.
GLSTM_STEPS, GLSTM_STEP_LAUNCHES, GLSTM_FWD_K2 = 10, (25, 13), 13
FLOW_FEW_STEPS = 4  # phase 22 (c): ResGNN Fourier and the per-node LSTM
# Phase 23: K2's and K3's (F, O) at the forecasting convs, B = 50, K = 2:
# ResGNN's residual conv, the gLSTM gates' h-conv and its dx, the conv
# stack's first and residual convs.
FLOW_K2_SHAPES = {"64->64": (64, 64), "64->256": (64, 256),
                  "256->64": (256, 64), "64->32": (64, 32),
                  "32->32": (32, 32)}
FLOW_K3_SHAPES = {"64,64": (64, 64), "64,256": (64, 256), "32,32": (32, 32)}
# Phase 24: the paper's other filters on the MNIST ChebNet, 8 adam steps
# each; lanczos_conv at K=5 through K1.
FILTERS, FILTER_STEPS, LANCZOS_K = ("fourier", "spline", "lanczos"), 8, 5
# The probes (phase 18) and the Pallas probe each replaces.
PROBE_SOURCE = "cnn_graph_tpu_torch/csrc/probes.cu"
PROBE_REPLACES = {"mxu": "experiments/_probe.py:154",       # _mxu_probe
                  "pred": "experiments/_probe.py:253",      # _pred_probe
                  "loopcost": "experiments/_probe.py:393"}  # main_loopcost
# Phase 25 (c): the node-classification driver at its defaults (JAX's:
# 100,000 nodes, 16 classes, 32 features, hidden 64, K=3, 200 steps);
# K-1 K1 launches per layer of a request.
DRIVER_NODES, DRIVER_CLASSES, DRIVER_FEATURES = 100000, 16, 32
DRIVER_REQUEST_K1 = 2 * (3 - 1)
HERE = os.path.dirname(os.path.abspath(__file__))
# Reduced counts: P1/P2 iterations of the longer timed chain (sq1024 an
# eighth, at least 32), cuBLAS chain links, P3 chained calls of 2048
# dots in the longer chain, and the plain versions' longer chains.
PROBE_ITERS, PEAK_ITERS, PROBE_CALLS = 200, 20, 6
PLAIN_PROBE_ITERS, PLAIN_PROBE_CALLS = 3, 2


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


# Spin cycles per call enqueued behind device_ms's spin kernel: 2 ms at
# the H100's 1.98 GHz boost clock, more than a wrapper's host time.
SPIN_CYCLES_PER_CALL = 4_000_000


@contextlib.contextmanager
def call_seconds(module, name: str):
    """The seconds of each call of ``module.name`` made inside the block,
    in a list: a step of a builder, timed where the builder calls it."""
    fn, spent = getattr(module, name), []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent.append(time.perf_counter() - t0)

    setattr(module, name, timed)
    try:
        yield spent
    finally:
        setattr(module, name, fn)


def cuda_ms(fn, n: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``n`` calls after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def device_ms(fn, n: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``n`` calls after one
    warm-up call, from CUDA events, with the host's enqueue hidden: a
    spin kernel holds the stream while the host enqueues the ``n`` calls,
    so the events time the device work alone.  ``cuda_ms`` times both,
    which for a kernel shorter than its wrapper's host time is the
    host's; requests and steps take ``cuda_ms``."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * (n + 1))
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def rows_plain(op, args, scale):
    """The row walk's plain version (``banded_rows_reference``) on ``op``'s
    layout."""
    lay = layout_of(op)
    if lay == "dkw":
        bands, sched, levels = op.bands_dkw, op.sched_dkw, op.levels
    elif lay == "ragged":
        bands, sched, levels = (op.band,), op.sched, op.levels
    else:
        bands, sched, levels = (op.band,), None, (op.band.shape[1],)
    return banded_rows_reference(bands, op.base, sched, op.nz_rowptr,
                                 op.nz_win, *args, layout=lay, levels=levels,
                                 G=op.rows_per_step, band_scale=scale)


def band_kernel_check(op, gen, what: str, lib: dict) -> dict:
    """``op``'s layout kernel (K1, K5 or K6) against its window plain
    version and the row walk's plain version, at C = FIN for every form it
    has; all timed, each time beside the
    sparse bound (``sparse_roofline``), the block format's work
    (``spmm_roofline``) and, for L@x, phase 16's library time ``lib``
    (the same matrix in CSR, by dtype).  Tolerances of ``_check_close``."""
    x, x0, c, scale = _layout_inputs(op, gen)
    plain = _plain_banded(op)
    dt = {torch.int8: "int8", torch.bfloat16: "bf16"}.get(op.compute_dtype,
                                                           "f32")
    rec = {"max_abs_err": 0.0, "rows_max_abs_err": 0.0,
           "library_ms": lib.get(dt)}
    forms = {"spmm": (x, None, None), "hop": (x, x0, None)}
    if c is not None:  # the adjoint hop, float only
        forms["hop_c"] = (x, x0, c)
    for form, args in forms.items():
        def kern(a=args):
            return layout_call(op, *a, band_scale=scale)

        def ref(a=args):
            return layout_call(plain, *a, band_scale=scale)

        def rref(a=args):
            return rows_plain(op, a, scale)

        got = kern()
        pre = "" if form == "spmm" else form + "_"
        for key, want in ((pre + "max_abs_err", ref()),
                          (pre + "rows_max_abs_err", rref())):
            torch.cuda.synchronize()
            rec[key] = _check_close(got, want, f"{what} {form} ({key})")
            top = key[len(pre):]
            rec[top] = max(rec[top], rec[key])
        extra = sum(a is not None for a in args[1:])
        rec[pre + "ms"] = device_ms(kern, 20)
        rec[pre + "plain_ms"] = device_ms(ref, 3)
        rec[pre + "rows_plain_ms"] = device_ms(rref, 2)
        rec[pre + "roofline"] = sparse_roofline(
            op, rec[pre + "ms"] / 1e3, FIN, extra_inputs=extra)
        rec[pre + "block_roofline"] = spmm_roofline(
            op, rec[pre + "ms"] / 1e3, FIN, extra_inputs=extra)
    return rec


def print_band_kernel(what: str, rec: dict, gpu: str):
    """One line per banded kernel: each form's time beside its plain
    versions', its sparse bound and its block format's work; the library
    time beside L@x."""
    def one(pre):
        r, b = rec[pre + "roofline"], rec[pre + "block_roofline"]
        rows = (f", row walk plain {rec[pre + 'rows_plain_ms']:.4f}"
                if pre + "rows_plain_ms" in rec else "")
        return (f"{rec[pre + 'ms']:.4f} ms (plain {rec[pre + 'plain_ms']:.4f}"
                f"{rows} ms; sparse bound {r['bound_us'] / 1e3:.4f} ms "
                f"{r['bound_by']}, block format's work "
                f"{b['bound_us'] / 1e3:.4f} ms {b['bound_by']})")
    lib = ("none" if rec["library_ms"] is None
           else f"{rec['library_ms']:.4f} ms")
    c = f", +c {one('hop_c_')}" if "hop_c_ms" in rec else ""
    inplace = (f"; in place {rec['hop_inplace_ms']:.4f} ms vs out of place "
               f"{rec['hop_outofplace_ms']:.4f} ms" if "hop_inplace_ms" in rec
               else "")
    rows = (f" (row walk plain {rec['rows_max_abs_err']:.3g})"
            if "rows_max_abs_err" in rec else "")
    print(f"kernel {what} C={FIN}: max_abs_err {rec['max_abs_err']:.3g}"
          f"{rows}, L@x {one('')}; torch.sparse.mm {lib}; hop {one('hop_')}"
          f"{c}{inplace} [{gpu}]", flush=True)


# ------------------------------------- K5, K6, in place, bench's chains


def cast_op(op, dt=torch.float32):
    """A float banded operator (single-chip or sharded) in ``dt``, every
    band array converted."""
    return dataclasses.replace(
        op, band=op.band.to(dt),
        bands_dkw=None if op.bands_dkw is None else tuple(
            b.to(dt) for b in op.bands_dkw))


def band_launches() -> dict:
    return {lay: f.launches for lay, f in LAYOUT_KERNELS.items()}


def reset_band_launches():
    torch.cuda.synchronize()
    for f in LAYOUT_KERNELS.values():
        f.launches = 0
        f.form_launches.clear()


def layout_of(op) -> str:
    """The layout whose kernel an operator's products run."""
    if op.bands_dkw is not None:
        return "dkw"
    return "ragged" if op.levels else "uniform"


def _check_close(got, want, what: str) -> float:
    """Tolerances of phase 3: int8 bit-identical; bf16 one bf16 ulp (both
    round an f32 accumulation of exact bf16 products, summed in another
    order); f32 atol 1e-4 (another summation order).  Returns the
    largest absolute difference."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: dtype/shape")
    if got.dtype == torch.int8:
        check(torch.equal(got, want), f"{what} not bit-identical")
        return float((got.int() - want.int()).abs().max())
    torch.testing.assert_close(
        got.float(), want.float(), atol=1e-4,
        rtol=2**-7 if got.dtype == torch.bfloat16 else 0.0)
    return float((got.float() - want.float()).abs().max())


def _layout_inputs(op, gen):
    """x, x0, c at C = FIN in the operator's compute dtype (c None for
    int8) and the band scale."""
    x, x0, c = (torch.randn(op.m_padded, FIN, generator=gen,
                            device=op.base.device) for _ in range(3))
    if op.compute_dtype == torch.int8:
        return op.quantize(x), op.quantize(x0), None, op.band_scale
    return (*(t.to(op.compute_dtype) for t in (x, x0, c)), None)


def inplace_phase(op, gen, what: str) -> dict:
    """The in-place hop (``donate``): bit-identical to the out-of-place
    launch and written into x0's storage; both timed in turns."""
    x, x0, _, scale = _layout_inputs(op, gen)
    want = layout_call(op, x, x0, band_scale=scale)
    buf = x0.clone()
    ptr = buf.data_ptr()
    got = layout_call(op, x, buf, band_scale=scale, donate=True)
    torch.cuda.synchronize()
    check(got is buf and got.data_ptr() == ptr,
          f"{what}: the in-place hop did not return x0's storage")
    check(torch.equal(got, want), f"{what}: the in-place hop is not "
          "bit-identical to the out-of-place one")

    def outplace():
        return layout_call(op, x, x0, band_scale=scale)

    def inplace():
        return layout_call(op, x, buf, band_scale=scale, donate=True)

    t = [device_ms(f, 20) for f in (outplace, inplace, inplace, outplace)]
    return {"hop_outofplace_ms": (t[0] + t[3]) / 2,
            "hop_inplace_ms": (t[1] + t[2]) / 2}


def make_chain(op, u: int, k: int = K):
    """bench.py's chain (:461-474, :497-506): ``u`` K-blocks of
    ``cheby_finals(op, ., k)``; float carries renormalised to unit RMS
    after each block, int8 carries kept (one quantize in, one dequantize
    out).  Returns the final carry in float."""
    quant = op.compute_dtype == torch.int8

    def chain(x):
        with torch.no_grad():
            if quant:
                q = op.quantize(x.float())
                for _ in range(u):
                    q = cheby_finals(op, q, k)
                return op.dequantize(q)
            for _ in range(u):
                y = cheby_finals(op, x, k).float()
                x = (y * torch.rsqrt(y.pow(2).mean() + 1e-6)).to(x.dtype)
            return x

    return chain


def chain_phase(op, X, what: str, gpu: str) -> dict:
    """One bench chain on ``op``: K-1 launches of its layout's kernel per
    K-block and no other, the int8 chain bit-identical to the plain
    chain's and bf16 within 2e-2 of its max (one K-block), then us per
    SpMM by slope fit for both chains, Gedges/s and the roofline of the
    hop (23 of the 24 products).  ``launches`` is the one checked
    K-block's count, read before the timing runs."""
    kernel = LAYOUT_KERNELS[layout_of(op)]
    plain = _plain_banded(op)
    reset_band_launches()
    got = make_chain(op, 1)(X)
    torch.cuda.synchronize()
    launches = band_launches()
    n_launches = kernel.launches
    check(n_launches == K - 1 and sum(launches.values()) == K - 1,
          f"chain {what}: launches {launches}, want {K - 1} of "
          f"{layout_of(op)}")
    want = make_chain(plain, 1)(X)
    torch.cuda.synchronize()
    check(sum(band_launches().values()) == K - 1,
          f"chain {what}: the plain chain launched kernels")
    err = float((got - want).abs().max())
    if op.compute_dtype == torch.int8:
        check(torch.equal(got, want), f"chain {what}: int8 chain not "
              "bit-identical to the plain chain")
    else:
        check(err <= 2e-2 * float(want.abs().max()), f"chain {what}: off "
              f"the plain chain by {err:.3g} of max "
              f"{float(want.abs().max()):.3g}")
    per, fixed = slope_time(lambda u: make_chain(op, u), (X,),
                            units=CHAIN_UNITS)
    t = per / (K - 1)
    plain_per, _ = slope_time(lambda u: make_chain(plain, u), (X,),
                              units=PLAIN_CHAIN_UNITS, reps=1)
    plain_t = plain_per / (K - 1)
    roof = spmm_roofline(op, t, X.shape[1], extra_inputs=1)
    rec = {"layout": layout_of(op), "launches": n_launches,
           "us_per_spmm": t * 1e6, "gedges_per_s": op.nnz / t / 1e9,
           "fixed_ms": fixed * 1e3, "plain_us_per_spmm": plain_t * 1e6,
           "max_abs_err": err, "roofline": roof}
    print(f"chain {what} ({KERNEL_ID[rec['layout']]}) K={K} C={X.shape[1]}: "
          f"{rec['us_per_spmm']:.2f} us per SpMM, {rec['gedges_per_s']:.4f} "
          f"Gedges/s, {roof['achieved_frac_of_bound']:.3f} of the "
          f"{roof['bound_by']} bound {roof['bound_us']:.2f} us; plain "
          f"chain {rec['plain_us_per_spmm']:.2f} us per SpMM; max |kernel - "
          f"plain| {err:.3g} [{gpu}]", flush=True)
    return rec


def banded_serve_phase(served: dict, reqs: list, kernel, what: str,
                       gpu: str) -> dict:
    """Serve ``reqs`` through each handle of ``served``: K-1 launches of
    ``kernel`` per request and no other banded kernel, finite [m, 16]
    logits, and each request's logits against the same request through
    the plain version on the card (phase 4's checks); in int8 also one
    ``quant_kernel`` and K ``dequant_kernel`` launches a conv and request,
    none in a float mode (``conversions``: (quantize, dequantize) by
    mode)."""
    launches, logits, conversions = {}, {}, {}
    for mode, serving in served.items():
        op = serving.model.op
        reset_band_launches()
        reset_quant_launches()
        logits[mode] = [serving(x) for x in reqs[mode]]
        torch.cuda.synchronize()
        launches[mode] = kernel.launches
        conversions[mode] = quant_launches()
        n = len(reqs[mode])
        check(launches[mode] == n * (K - 1)
              and sum(band_launches().values()) == launches[mode],
              f"{what} {mode}: {band_launches()} launches for {n} requests")
        convs = len(serving.params["convs"])
        want = ((n * convs, n * convs * K)
                if op.compute_dtype == torch.int8 else (0, 0))
        check(conversions[mode] == want, f"{what} {mode}: int8 conversion "
              f"launches {conversions[mode]} for {n} requests of {convs} "
              f"conv(s), want {want}")
        for y in logits[mode]:
            check(tuple(y.shape) == (op.m, CLASSES) and bool(
                torch.isfinite(y).all()), f"{what} {mode}: bad logits")
        # The same requests through the plain version on the card.
        twin = _plain_twin(op)
        p = serving.params["convs"][0]
        err = 0.0
        for x, y in zip(reqs[mode], logits[mode]):
            with torch.inference_mode():
                want = cheby_conv(x[None], twin, p["w"])[0] + p["b"]
            e = float((y - want).abs().max())
            err = max(err, e)
            # int8: identical carries, the same taps -> equal up to 1e-4.
            # bf16: carries rounded to bf16 after sums in another order
            # may differ by an ulp and travel along 24 hops.
            tol = 1e-4 if op.compute_dtype == torch.int8 else \
                2e-2 * float(want.abs().max())
            check(e <= tol, f"{what} {mode}: served logits off the plain "
                  f"version by {e:.3g} (limit {tol:.3g})")
        print(f"{what} {mode}: {n} requests, {launches[mode]} "
              f"{KERNEL_ID[layout_of(op)]} launches, int8 conversions "
              f"(quantize, dequantize) {conversions[mode]}, logits "
              f"{tuple(logits[mode][0].shape)}, max |served - plain| "
              f"{err:.3g}", flush=True)
    return {"launches": launches, "logits": logits,
            "conversions": conversions}


def csr_operand(L, m_padded: int, dev):
    """The rescaled Laplacian that ``device_laplacian`` packs, as one
    padded ``[m_padded, m_padded]`` CSR matrix on the card (f32 values),
    for the library call."""
    A = graphs.rescale_laplacian(L).tocsr()
    A.eliminate_zeros()
    m = A.shape[0]
    crow = np.concatenate([A.indptr, np.full(m_padded - m, A.indptr[-1])])
    return (torch.from_numpy(crow.astype(np.int64)).to(dev),
            torch.from_numpy(A.indices.astype(np.int64)).to(dev),
            torch.from_numpy(A.data.astype(np.float32)).to(dev), m_padded)


def library_phase(csr, gen, what: str, gpu: str) -> dict:
    """One ``torch.sparse.mm`` of the same matrix in CSR at C = FIN, by
    dtype, timed: the library yardstick for ``L @ x``, used nowhere in
    the port.  torch refuses int8 ("spmm not implemented for 'Char'"),
    so int8 has none.  ``calls`` holds each timed call, for the
    profile."""
    crow, col, val, mp = csr
    out = {"calls": {}, "int8": None}
    for lab, dt in DTYPES.items():
        x = torch.randn(mp, FIN, generator=gen, device=crow.device).to(dt)
        with warnings.catch_warnings():  # "sparse CSR support is beta"
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_csr_tensor(crow, col, val.to(dt), size=(mp, mp))
        out["calls"][lab] = lambda _=None, A=A, x=x: torch.sparse.mm(A, x)
        out[lab] = device_ms(out["calls"][lab], 10)
        print(f"library {what} {lab}: torch.sparse.mm (CSR) C={FIN} "
              f"{out[lab]:.4f} ms [{gpu}]", flush=True)
    return out


def dense_cheby_bound(op, B: int, F: int, O: int, K_: int) -> dict:
    """The bound of one K2 call (or K3, whose operands have the same
    sizes) from its shapes: K-1 dense products ``[Mp, Mp] @ [Mp, B*F]``
    plus K taps ``[Mp*B, F] @ [F, O]``; L read once in its dtype, x and
    w (g for K3) read and y (dW) written once in f32."""
    mp = op.m_padded
    ops = (K_ - 1) * 2 * mp * mp * B * F + K_ * 2 * mp * B * F * O
    e = op.mat.element_size()
    nbytes = mp * mp * e + 4 * (B * mp * F + K_ * F * O + B * mp * O)
    return roofline(ops, nbytes, op.compute_dtype)


def bound_keys(r: dict) -> dict:
    """A roofline's bound as the kernel record's keys."""
    return {"bound_ms": r["bound_us"] / 1e3, "bound_by": r["bound_by"]}


def work_keys(r: dict) -> dict:
    """The block format's work (``spmm_roofline``) as the record's keys."""
    return {"block_work_ms": r["bound_us"] / 1e3,
            "block_work_by": r["bound_by"]}


def request_features(positions, n: int, seed: int = 1):
    """Patch labels [M] and ``n`` feature matrices [M, FIN] as
    bench.py:140-149 makes them: a per-class signature per spatial patch
    plus fresh noise per matrix."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(positions.shape[0]))
    patch = (positions[:, 0] // (side / 8)).astype(int) * 8 + (
        positions[:, 1] // (side / 8)).astype(int)
    labels = (patch % CLASSES).astype(np.int64)
    signatures = rng.normal(0, 1, (CLASSES, FIN)).astype(np.float32)
    return torch.from_numpy(labels), [torch.from_numpy(
        signatures[labels] + rng.normal(0, 1.0, (len(labels), FIN)).astype(
            np.float32)) for _ in range(n)]


class _PlainConversions:
    """An int8 twin's activation conversions on their plain expressions,
    called directly, so that a check against the twin does not run
    ``csrc/quant.cu`` on both sides."""

    def quantize(self, x, scale=None):
        return quant.quantize_reference(
            x, self.act_scale if scale is None else scale)

    def dequantize(self, q, dtype=torch.float32, scale=None):
        return quant.dequantize_reference(
            q, self.act_scale if scale is None else scale, dtype)


class _PlainQuantBanded(_PlainConversions, QuantBandedLaplacian):
    pass


def _plain_banded(op):
    """A banded operator (float or int8, any layout) whose products run
    its layout kernel's plain version, an int8 one's conversions too."""
    if isinstance(op, QuantBandedLaplacian):
        return _PlainQuantBanded(**{
            **{f.name: getattr(op, f.name) for f in dataclasses.fields(op)},
            "use_pallas": False})
    return dataclasses.replace(op, use_pallas=False)


class _PlainBsrMixin:
    """Every BSR kernel call on the plain version (float and int8)."""

    def kernel_call(self, x, x0, route, block_scale=None):
        if route == "K4":
            return bsr_colstream_reference(
                self.blocks, self.cs_meta, self.cs_gcols, self.cs_gcolptr,
                self.cs_groupptr, x, x0, G=self.rows_per_step,
                block_shape=self.block_shape, block_scale=block_scale)
        return bsr_csr_reference(self.blocks, self.block_rowptr,
                                 self.block_cols, x, x0,
                                 block_shape=self.block_shape,
                                 block_scale=block_scale)


class _PlainBsr(_PlainBsrMixin, BlockSparseLaplacian):
    pass


class _PlainQuantBsr(_PlainConversions, _PlainBsrMixin,
                     QuantBlockSparseLaplacian):
    pass


class _PlainQuantDense(_PlainConversions, QuantDenseLaplacian):
    """The dense int8 twin with its float64 accumulator, the route that
    the int32 ``_int_mm`` replaced, and the plain conversions."""

    def _acc(self, x_q):
        return self._acc_f64(x_q)


_PLAIN = {BlockSparseLaplacian: _PlainBsr,
          QuantBlockSparseLaplacian: _PlainQuantBsr,
          QuantDenseLaplacian: _PlainQuantDense}


def _plain_twin(op):
    """The operator with every kernel call on its plain version."""
    if isinstance(op, (BandedLaplacian, QuantBandedLaplacian)):
        return _plain_banded(op)
    return _PLAIN[type(op)](**{f.name: getattr(op, f.name)
                               for f in dataclasses.fields(op)})


def _device_kernels(avg):
    """Device kernel events of ``key_averages()``, without the device-side
    spans of ``record_function`` ranges, which would count twice."""
    return sorted((e for e in avg if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation),
                  key=lambda e: -e.device_time_total)


def _busy_ms(avg, n: int) -> float:
    return sum(e.device_time_total for e in _device_kernels(avg)) / n / 1e3


def _trace(fn, n: int, out_dir: str, mode: str):
    """``key_averages()`` of ``n`` calls of ``fn`` under torch.profiler,
    its table written to ``out_dir/profile_<mode>.txt``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof, profiling.recording(ranges=True):
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    with open(os.path.join(out_dir, f"profile_{mode}.txt"), "w") as f:
        f.write(avg.table(sort_by="cuda_time_total", row_limit=40))
    return avg, prof


def _pct(ms: float, total: float) -> float:
    return 100 * ms / total if total else float("nan")


def _print_top(avg, busy: float, n: int):
    kernels = _device_kernels(avg)
    ops = sorted((e for e in avg if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.device_time_total)
    for kind, evs in (("kernel", kernels[:6]), ("op", ops[:6])):
        for e in evs:
            ms = e.device_time_total / n / 1e3
            print(f"  {kind} {e.key[:64]}: {ms:.3f} ms "
                  f"({_pct(ms, busy):.1f}%), {e.count / n:g} calls")


def profile_phase(served: dict, x: torch.Tensor, lat: dict, out_dir: str,
                  gpu: str, n: int = 3):
    """Device-time breakdown of ``n`` requests per serving mode."""
    os.makedirs(out_dir, exist_ok=True)
    for mode, serving in served.items():
        for _ in range(2):
            serving(x)
        avg, _ = _trace(lambda s=serving: s(x), n, out_dir, mode)
        busy = _busy_ms(avg, n)
        print(f"profile {mode}: device {busy:.3f} ms per request, "
              f"{100 * busy / lat[mode]:.1f}% of the {lat[mode]:.3f} ms "
              f"latency [{gpu}]")
        _print_top(avg, busy, n)


def train_parts(layout: str = "dkw") -> tuple:
    """Parts of a banded training step by the span that holds them (the
    recorder's, ``utils/profiling.py``); the taps, dW and injections hold
    their operands' casts.  The kernel's spans are read from their
    device-side spans (one kernel each): a kernel launched through ctypes
    is not linked to the host-side event."""
    k = KERNEL_ID[layout]
    return (
        (f"{k} L@x", f"band_{layout}.spmm"),
        (f"{k} hop", f"band_{layout}.hop"),
        (f"{k} +c", f"band_{layout}.hop_c"),
        ("taps", "conv.taps"), ("dW", "conv.dW"),
        ("injections", "conv.injections"),
        ("adam", "Optimizer.step#Adam.step"),
    )


# The same for the scattered graph's BSR training step.
BSR_TRAIN_PARTS = (
    ("K4 L@x", "bsr_colstream.spmm"), ("K4 hop", "bsr_colstream.hop"),
    ("taps (forward)", "conv.taps"),
    ("casts", "aten::_to_copy"), ("adam", "Optimizer.step#Adam.step"),
)


def train_profile_phase(run, step_ms: float, out_dir: str, gpu: str,
                        n: int = 2, mode: str = "train_bf16",
                        parts_of=train_parts()):
    """Device-time breakdown of ``n`` bf16 training steps by the parts
    ``parts_of`` names."""
    os.makedirs(out_dir, exist_ok=True)
    run(1)
    avg, _ = _trace(lambda: run(1), n, out_dir, mode)
    busy = _busy_ms(avg, n)
    print(f"profile {mode}: device {busy:.3f} ms per step, "
          f"{100 * busy / step_ms:.1f}% of the {step_ms:.3f} ms step [{gpu}]")
    events = {e.key: e for e in avg if e.device_type == DeviceType.CPU}
    events.update({e.key: e for e in avg if e.device_type == DeviceType.CUDA
                   and e.is_user_annotation
                   and e.key.startswith(("band_", "bsr_"))})
    parts = 0.0
    for label, key in parts_of:
        e = events.get(key)
        ms = 0.0 if e is None else e.device_time_total / n / 1e3
        parts += ms
        calls = 0 if e is None else e.count / n
        print(f"  part {label}: {ms:.3f} ms ({_pct(ms, busy):.1f}%), "
              f"{calls:g} calls")
    print(f"  part rest: {busy - parts:.3f} ms")
    _print_top(avg, busy, n)


def _spans_ms(prof, name: str) -> list:
    """Device-side spans of the ``record_function`` ranges called
    ``name``, in launch order, in ms: each holds one ctypes kernel."""
    spans = sorted((e for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and e.is_user_annotation and e.name == name),
                   key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in spans]


def chebnet_profile_phase(run, step_ms: float, out_dir: str, gpu: str,
                          n: int = 2, mode: str = "chebnet_train_f32",
                          optimizer=("adam", "Optimizer.step#Adam.step"),
                          k2_forward: int = 1,
                          stacked="layer 0 stacked basis"):
    """Device-time breakdown of ``n`` f32 training steps of a model whose
    ``k2_forward`` fused convs all take dx: each step launches K2 for
    their forwards, then K2 for each dx (each followed by its K3), so
    of each step's 2 * ``k2_forward`` K2 spans the first half are
    forwards (ChebNet: 1, they alternate; ResGNN: 8).  K3's fold and the
    fused conv's layout copies are their ranges' aten kernels, to which
    the ctypes kernels are not linked.  ``optimizer``: the update's label
    and range (``train_classifier``'s torch adam, or the Trainer's
    chain); ``stacked``: the label of the convs on the stacked route."""
    os.makedirs(out_dir, exist_ok=True)
    run(1)
    avg, prof = _trace(lambda: run(1), n, out_dir, mode)
    busy = _busy_ms(avg, n)
    print(f"profile {mode}: device {busy:.3f} ms per step, "
          f"{100 * busy / step_ms:.1f}% of the {step_ms:.3f} ms step [{gpu}]")
    k2 = _spans_ms(prof, "cheby_fused.K2")
    events = {e.key: e for e in avg if e.device_type == DeviceType.CPU}

    def cpu_ms(*keys):
        return sum(events[k].device_time_total for k in keys
                   if k in events) / n / 1e3

    fold = cpu_ms("cheby_fused.K3.fold")
    forward = [i % (2 * k2_forward) < k2_forward for i in range(len(k2))]
    parts = (
        ("K2 forward", sum(t for t, f in zip(k2, forward) if f) / n),
        ("K2 dx", sum(t for t, f in zip(k2, forward) if not f) / n),
        ("K3 dW", sum(_spans_ms(prof, "cheby_fused.K3")) / n),
        ("K3 fold", fold),
        # The conv's ranges hold the fold's range: counted once, above.
        ("K2/K3 layout copies", cpu_ms("cheby_conv_fused.forward",
                                       "cheby_conv_fused.dx",
                                       "cheby_conv_fused.dW") - fold),
        (stacked, cpu_ms("conv.stacked")),
        ("fc forward", cpu_ms("fc")),
        (optimizer[0], cpu_ms(optimizer[1])),
    )
    for label, ms in parts:
        print(f"  part {label}: {ms:.3f} ms ({_pct(ms, busy):.1f}%)")
    print(f"  part rest (backward of layer 0 and fc, loss): "
          f"{busy - sum(ms for _, ms in parts):.3f} ms")
    _print_top(avg, busy, n)


def _on(params, dev):
    return tree_map(lambda t: t.detach().to(dev), params)


def loss_and_grads(model, params, data, seed: int):
    """One step's loss and parameter gradients, dropout drawn from a
    generator seeded with ``seed``."""
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    gen = torch.Generator(device=data[0].device).manual_seed(seed)
    loss = model.loss(p, *data, train=True, generator=gen)
    loss.backward()
    return loss.detach(), [t.grad for t in tree_leaves(p)]


def check_step(model, twin, params, data, tol: float, what: str, launches):
    """One step's loss and every gradient through ``model`` against the
    same step through ``twin``, the same dropout seed, and no kernel
    launch (``launches()``: the count) in the twin's step.  Returns the
    loss's relative error and the largest gradient error relative to its
    max."""
    loss, grads = loss_and_grads(model, params, data, seed=1)
    torch.cuda.synchronize()
    before = launches()
    loss_p, grads_p = loss_and_grads(twin, params, data, seed=1)
    torch.cuda.synchronize()
    check(launches() == before, f"{what}: the plain twin launched "
          f"{launches() - before} kernels")
    loss_err = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    check(loss_err <= tol, f"{what}: loss {float(loss)} vs plain "
          f"{float(loss_p)}")
    grad_err = 0.0
    for g, gp in zip(grads, grads_p):
        check(bool(torch.isfinite(g).all()), f"{what}: gradient")
        err = float((g - gp).abs().max() / gp.abs().max())
        check(err <= tol, f"{what}: gradient {tuple(g.shape)} off the "
              f"plain version by {err:.3g} of its max (limit {tol})")
        grad_err = max(grad_err, err)
    return loss_err, grad_err


def train_phase(op, dropout: float, data, mode: str,
                kernel=banded_dkw) -> dict:
    """The deep model's training run on one operator: launches of
    ``kernel`` (its layout's banded kernel), loss, one step against the
    plain version, ms per step for both."""
    dev = op.base.device
    model = NodeClassifier(op, FIN, CLASSES, hidden=[FIN], K=K,
                           dropout=dropout,
                           generator=torch.Generator().manual_seed(0))
    params = _on(model.param_tree(), dev)

    def run(steps, m=model, seed=0):
        return train_node_classifier(
            m, params, *data, steps=steps, learning_rate=LEARNING_RATE,
            generator=torch.Generator(device=dev).manual_seed(seed))

    torch.cuda.reset_peak_memory_stats()
    reset_band_launches()
    _, losses = run(TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = kernel.launches
    check(sum(band_launches().values()) == launches, f"train {mode}: "
          f"another banded kernel launched: {band_launches()}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    forms = dict(kernel.form_launches)
    want = {f: TRAIN_STEPS * n for f, n in STEP_FORMS.items()}
    check(launches == TRAIN_STEPS * 3 * (K - 1) and forms == want,
          f"train {mode}: {launches} launches {forms} for {TRAIN_STEPS} "
          f"steps, want {want}")
    losses = losses.tolist()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train {mode}: losses {losses} not finite and falling")

    # One step through the kernel and through the plain version.
    twin = copy.copy(model)
    twin.op = _plain_twin(op)
    # f32: the same arithmetic summed in another order, through 48 hops;
    # bf16: carries rounded after sums in another order may land an ulp
    # apart and travel along the chains, as in serving.
    loss_err, grad_err = check_step(
        model, twin, params, data, 1e-3 if mode == "f32" else 2e-2,
        f"train {mode}", lambda: kernel.launches)

    step_ms = cuda_ms(lambda: run(TRAIN_STEPS), 1) / TRAIN_STEPS
    plain_step_ms = cuda_ms(lambda: run(1, m=twin), 1)
    return {"launches": launches, "forms": forms, "losses": losses,
            "peak_gb": peak_gb,
            "loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "ms": step_ms, "plain_ms": plain_step_ms, "run": run}


# ------------------------------------------------------------- ChebNet, K2, K3


class _PlainDense(DenseLaplacian):
    """A dense operator whose fused conv runs the plain versions."""

    def fused_filter(self, x, w):
        return cheby_conv_fused_reference(x, self, w)

    def fused_dw(self, x, g, K):
        return cheby_dw_fused_reference(x, self, g, K)


def _plain_dense(op):
    return _PlainDense(**{f.name: getattr(op, f.name)
                          for f in dataclasses.fields(op)})


def cheby_launches() -> tuple:
    return cheby_conv_fused.launches, cheby_dw_fused.launches


def reset_cheby_launches():
    torch.cuda.synchronize()
    cheby_conv_fused.launches = cheby_dw_fused.launches = 0


def _kernel_vs_plain(kernel, plain, tol: float, what: str,
                     timer=None) -> dict:
    """One kernel call against its plain version on the same inputs,
    within ``tol`` of the plain result's largest entry, and both timed
    by ``timer`` (``cuda_ms``, looked up when called, by default)."""
    timer = timer or cuda_ms
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: shape/dtype")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(bool(torch.isfinite(got).all()) and err <= tol * scale,
          f"{what}: max |kernel - plain| {err:.3g} over limit "
          f"{tol * scale:.3g}")
    return {"max_abs_err": err, "scale": scale, "ms": timer(kernel, 10),
            "plain_ms": timer(plain, 3)}


# K2's shapes (B, level, F, O): the bench's dense_fused conv
# (bench.py:926-936) on the 976-node level 0, and ChebNet layer 1's
# forward and dx (W^T) on the 244-node level 2.
K2_SHAPES = {"bench": (CHEB_B, 0, 32, 32), "layer1": (CHEB_B, 2, 32, 64),
             "dx": (CHEB_B, 2, 64, 32)}


# The shapes at which K3 is held and timed: the bench's (x and g [100,
# 976, 32]) and ChebNet layer 1's (x [100, 244, 32], g [100, 244, 64]).
K3_SHAPES = ("bench", "layer1")


def _fitted_geometry(kernel: str, lab: str, shape: str, B: int, op, F: int,
                     O: int) -> dict:
    """``kernel``'s geometry at a shape, with one CTA's shared memory and
    the clusters the card holds at once; fails unless it fits."""
    dev = op.mat.device
    geo = conv_geometry(B, op.m_padded, F, O,
                        torch.cuda.get_device_properties(
                            dev).multi_processor_count)
    geo.update(conv_resources(geo["rows"], op.mat.dtype, geo["cluster"],
                              kernel))
    check(0 < geo["smem"] <= 232_448 and geo["resident_clusters"] >= 1,
          f"{kernel} {lab} {shape}: {geo} does not fit the card")
    return geo


def cheby_kernel_phase(Ls, dev, gen: torch.Generator) -> dict:
    """K2 against its plain version at the bench's dense_fused shape,
    ChebNet layer 1's forward shape and its dx shape, and K3 at the bench
    and layer-1 shapes, in f32 and bf16, all timed by device work
    (``device_ms``), and K3's fold of its partials alone.  Tolerances, of
    the largest plain entry: f32 1e-4, the same products summed in
    another order through 24 hops; bf16 1e-2, a carry next to a bf16
    rounding boundary may round one ulp (2^-8) apart and later hops carry
    that along."""
    rec = {}
    for lab, dt in DTYPES.items():
        tol = 1e-4 if lab == "f32" else 1e-2
        for shape, (B, lvl, F, O) in K2_SHAPES.items():
            op = device_laplacian(Ls[lvl], fmt="dense", dtype=dt, device=dev,
                                  use_pallas=True)
            x = torch.randn(B, op.m, F, generator=gen, device=dev)
            w = 0.05 * torch.randn(CHEB["K"][0], F, O, generator=gen,
                                   device=dev)
            K_ = w.shape[0]
            # K3's operands (x, g; dW) have K2's sizes (x, w; y): one bound.
            bound = dense_cheby_bound(op, B, F, O, K_)
            rec[f"{lab}_{shape}"] = {
                **_kernel_vs_plain(
                    lambda: fused_filter(x, op, w),
                    lambda: cheby_conv_fused_reference(x, op, w), tol,
                    f"K2 {lab} {shape}", timer=device_ms),
                "bound": bound,
                "geometry": _fitted_geometry("K2", lab, shape, B, op, F, O)}
            if shape not in K3_SHAPES:
                continue
            g = torch.randn(B, op.m, O, generator=gen, device=dev)
            parts = _launch_dw(op, x, g, K_)
            rec[f"{lab}_{shape}_K3"] = {
                **_kernel_vs_plain(
                    lambda: cheby_dw_fused(x, op, g, K_),
                    lambda: cheby_dw_fused_reference(x, op, g, K_), tol,
                    f"K3 {lab} {shape}", timer=device_ms),
                "bound": bound,
                "fold_ms": device_ms(
                    lambda: _fold_dw_partials(parts, op.compute_dtype), 10),
                "parts_mb": parts.numel() * 4 / 1e6,
                "geometry": _fitted_geometry("K3", lab, shape, B, op, F, O)}
            del parts
    return rec


def chebnet_model(Ls, dt, dev):
    ops = [device_laplacian(L, fmt="dense", dtype=dt, device=dev,
                            use_pallas=True) for L in Ls]
    model = ChebNet(ops, **CHEB, generator=torch.Generator().manual_seed(0))
    return model, _on(model.param_tree(), dev)


def chebnet_serve_phase(model, params, reqs, mode: str) -> dict:
    """Serve ``reqs`` through compile_serving: 1 K2 and 0 K3 launches per
    request, finite logits, the same logits as the plain twin's."""
    serving = compile_serving(model, params, reqs[0], int8=False)
    twin = compile_serving(map_operators(model, _plain_dense), params,
                           reqs[0], int8=False)
    reset_cheby_launches()
    logits = [serving(x) for x in reqs]
    torch.cuda.synchronize()
    launches = cheby_launches()
    check(launches == (len(reqs), 0), f"chebnet serve {mode}: launches "
          f"{launches} for {len(reqs)} requests, want ({len(reqs)}, 0)")
    reset_cheby_launches()
    want = [twin(x) for x in reqs]
    torch.cuda.synchronize()
    check(cheby_launches() == (0, 0), f"chebnet serve {mode}: the plain "
          "twin launched kernels")
    # f32: only layer 1's sums run in another order; bf16: as the kernel
    # checks, an operand may round one ulp apart and travel along.
    tol = 1e-3 if mode == "f32" else 2e-2
    err = 0.0
    for y, yp in zip(logits, want):
        check(tuple(y.shape) == (CHEB_B, CHEB["M"][-1])
              and bool(torch.isfinite(y).all()),
              f"chebnet serve {mode}: bad logits")
        e = float((y - yp).abs().max())
        check(e <= tol * float(yp.abs().max()), f"chebnet serve {mode}: "
              f"logits off the plain twin's by {e:.3g}")
        err = max(err, e)
    return {"launches": launches, "max_abs_err": err, "serving": serving,
            "ms": cuda_ms(lambda: serving(reqs[0]), 5),
            "plain_ms": cuda_ms(lambda: twin(reqs[0]), 3)}


def chebnet_train_phase(model, params, batch, mode: str) -> dict:
    """4 adam steps on one fixed batch: 2 K2 and 1 K3 launches per step,
    a finite loss that falls, one step against the plain twin."""
    dev = batch[0].device

    def run(steps, m=model, seed=0):
        return train_classifier(
            m, params, *batch, batch_size=CHEB_B, steps=steps,
            learning_rate=LEARNING_RATE,
            generator=torch.Generator(device=dev).manual_seed(seed))

    reset_cheby_launches()
    _, losses = run(TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = cheby_launches()
    check(launches == (2 * TRAIN_STEPS, TRAIN_STEPS),
          f"chebnet train {mode}: launches {launches} for {TRAIN_STEPS} "
          "steps")
    losses = losses.tolist()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"chebnet train {mode}: losses {losses} not finite and falling")
    twin = map_operators(model, _plain_dense)
    loss_err, grad_err = check_step(
        model, twin, params, batch, 1e-3 if mode == "f32" else 2e-2,
        f"chebnet train {mode}", lambda: sum(cheby_launches()))
    return {"launches": launches, "losses": losses, "loss_rel_err": loss_err,
            "grad_rel_err": grad_err, "run": run,
            "ms": cuda_ms(lambda: run(TRAIN_STEPS), 1) / TRAIN_STEPS,
            "plain_ms": cuda_ms(lambda: run(1, m=twin), 1)}


def chebnet_int8_phase(model, params, reqs, f32_serving) -> dict:
    """The default serving call, ``compile_serving(model, params, x)``:
    int8, every dense operator its ``QuantDenseLaplacian`` twin, the
    convs on the int8 streaming path with 0 K2 and 0 K3 launches, finite
    logits equal to the same serving on the CPU within 1e-4 of their max,
    and the int8 K=25 ``cheby_finals`` chain on the level-0 twin
    bit-identical on the card and on the CPU (exact float64 accumulation,
    one f32 emission).  The argmax agreement with the f32 serving over
    all requests is held to JAX's at this configuration,
    ``CHEB_INT8_AGREEMENT``, within 0.005 (2 of 400 rows: a near tie may
    fall either way).  JAX's int8 ChebNet itself agrees on 86.75%
    here, not the 95% its tests ask of a K=5 NodeClassifier
    (tests/test_quant_formats.py:312-313): the int8 recurrence over 24
    hops moves these random-weight logits by about 0.44 of their max.
    The largest int8 - f32 difference is returned too."""
    serving = compile_serving(model, params, reqs[0])
    check(all(isinstance(o, QuantDenseLaplacian)
              for o in serving.model.operators),
          "chebnet int8: the default serving call left an operator "
          "unquantized")
    reset_cheby_launches()
    logits = [serving(x) for x in reqs]
    torch.cuda.synchronize()
    launches = cheby_launches()
    check(launches == (0, 0), f"chebnet int8: K2/K3 launches {launches}")
    on_cpu = compile_serving(model, params, reqs[0].cpu())
    same, rel, err = 0, 0.0, 0.0
    for x, y in zip(reqs, logits):
        check(tuple(y.shape) == (CHEB_B, CHEB["M"][-1])
              and bool(torch.isfinite(y).all()), "chebnet int8: bad logits")
        want = on_cpu(x.cpu())
        e = float((y.cpu() - want).abs().max())
        check(e <= 1e-4 * float(want.abs().max()), f"chebnet int8: card "
              f"logits off the CPU's by {e:.3g}")
        err = max(err, e)
        f32 = f32_serving(x)
        same += int((y.argmax(1) == f32.argmax(1)).sum())
        rel = max(rel, float((y - f32).abs().max() / f32.abs().max()))
    agree = same / (len(reqs) * CHEB_B)
    check(abs(agree - CHEB_INT8_AGREEMENT) <= 0.005, f"chebnet int8: "
          f"argmax agreement with f32 {agree:.4f}, JAX's "
          f"{CHEB_INT8_AGREEMENT:.4f}")
    q = serving.model.operators[0]
    gen = torch.Generator(device=q.mat.device).manual_seed(5)
    xq = q.quantize(2.0 * torch.randn(q.m_padded, FIN, generator=gen,
                                      device=q.mat.device))
    with torch.inference_mode():
        chain = cheby_finals(q, xq, K)
        chain_cpu = cheby_finals(q.to("cpu"), xq.cpu(), K)
    check(chain.dtype == torch.int8 and torch.equal(chain.cpu(), chain_cpu),
          "chebnet int8: the K=25 chain differs between card and CPU")
    f64 = compile_serving(map_operators(serving.model, _plain_twin), params,
                          reqs[0])
    return {"launches": launches, "max_abs_err": err, "agreement": agree,
            "max_rel_diff": rel, "ms": cuda_ms(lambda: serving(reqs[0]), 5),
            "f64_ms": cuda_ms(lambda: f64(reqs[0]), 5)}


# ------------------------------------------------ scattered BSR, K4, K7-K9


def scattered_graph():
    """The bench's 50k scattered kNN graph (bench.py:776-782)."""
    z = np.random.default_rng(0).normal(size=(SCAT_N, SCAT_DIMS)).astype(
        np.float32)
    W = graphs.adjacency(*graphs.knn(z, k=SCAT_K, algorithm="auto"))
    perm = graphs.bandwidth_reducing_permutation(W)
    return graphs.laplacian(W[perm][:, perm].tocsr())


def scattered_features(m: int, n: int, seed: int = 2):
    """Labels [m] by node index in RCM order and ``n`` feature matrices
    [m, FIN], a class signature plus unit noise each, as bench.py:699-704
    makes them (the graph has no grid positions)."""
    rng = np.random.default_rng(seed)
    labels = (np.arange(m) * CLASSES // m).astype(np.int64)
    signatures = rng.normal(0, 1, (CLASSES, FIN)).astype(np.float32)
    return torch.from_numpy(labels), [torch.from_numpy(
        signatures[labels] + rng.normal(0, 1.0, (m, FIN)).astype(np.float32))
        for _ in range(n)]


def bsr_launches() -> dict:
    """Launches by kernel: K4 and each bsr_csr route."""
    return {"K4": bsr_colstream.launches, **bsr_csr.route_launches}


def reset_bsr_launches():
    torch.cuda.synchronize()
    bsr_colstream.launches = bsr_csr.launches = 0
    for c in (bsr_colstream.form_launches, bsr_csr.form_launches,
              bsr_csr.route_launches):
        c.clear()


def hub_graph(n: int = 3000, degree: int = 300, seed: int = 4):
    """A kNN graph (n Gaussian points in 8-D, k=6) whose node 0 is joined
    to ``degree`` others: one row of ``degree`` + 7 nonzeros, which the
    row kernel walks in warp-wide chunks of 32."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 8)).astype(np.float32)
    W = graphs.adjacency(*graphs.knn(z, k=6, algorithm="auto")).tolil()
    nb = rng.choice(np.arange(1, n), degree, replace=False)
    W[0, nb] = 0.5
    W[nb, 0] = 0.5
    return graphs.laplacian(W.tocsr())


def bsr_kernel_phase(op, route: str, forms, gen, what: str,
                     lib_ms=None, timed: bool = True) -> dict:
    """The row kernel as ``route`` on ``op`` against its plain version
    (``bsr_rows_reference``) and the block walk's (the plain twin's
    ``kernel_call``) at C = FIN, for each form in ``forms``; all three
    timed unless ``timed`` is false.  Tolerances: int8 bit-identical; f32
    1e-4 of the largest plain entry (another summation order); bf16 one
    bf16 ulp (all round one f32 accumulation).  ``lib_ms`` is phase 16's
    library time for the operator's dtype, printed beside."""
    dev = op.blocks.device
    x, x0 = (torch.randn(op.m_padded, FIN, generator=gen, device=dev)
             for _ in range(2))
    dt = op.compute_dtype
    if dt == torch.int8:
        x, x0, scale = op.quantize(x), op.quantize(x0), op.block_scale
    else:
        x, x0, scale = x.to(dt), x0.to(dt), None
    plain = _plain_twin(op)
    rows = (op.blocks, op.nz_rowptr, op.nz_cols, op.nz_pos)
    rec = {"max_abs_err": 0.0, "block_max_abs_err": 0.0,
           "library_ms": lib_ms}
    for form in forms:
        xx0 = None if form == "spmm" else x0

        def kern():
            return op.kernel_call(x, xx0, route, scale)

        def ref():
            return bsr_rows_reference(*rows, x, xx0, block_scale=scale)

        def block():
            return plain.kernel_call(x, xx0, route, scale)

        got = kern()
        for key, want in (("max_abs_err", ref()),
                          ("block_max_abs_err", block())):
            torch.cuda.synchronize()
            check(got.dtype == want.dtype == dt and got.shape == want.shape,
                  f"{what} {form}: dtype/shape")
            if dt == torch.int8:
                check(torch.equal(got, want), f"{what} {form} not "
                      f"bit-identical to the {key.split('_')[0]} plain "
                      "version")
                err = float((got.int() - want.int()).abs().max())
            else:
                err = float((got.float() - want.float()).abs().max())
                torch.testing.assert_close(
                    got.float(), want.float(),
                    rtol=2**-7 if dt == torch.bfloat16 else 0.0,
                    atol=1e-4 * float(want.float().abs().max()))
            rec[key] = max(rec[key], err)
        if not timed:
            continue
        pre = "" if form == "spmm" else form + "_"
        extra = int(xx0 is not None)
        rec[pre + "ms"] = device_ms(kern, 20)
        rec[pre + "plain_ms"] = device_ms(ref, 2)
        rec[pre + "block_plain_ms"] = device_ms(block, 2)
        rec[pre + "roofline"] = sparse_roofline(
            op, rec[pre + "ms"] / 1e3, FIN, extra_inputs=extra)
        rec[pre + "block_roofline"] = spmm_roofline(
            op, rec[pre + "ms"] / 1e3, FIN, extra_inputs=extra)
    return rec


def long_rows_phase(dev, gen) -> dict:
    """Phase 10's checks on ``hub_graph``, whose longest row holds more
    than 32 nonzeros: K4 and K7, L@x and the hop, f32, bf16 and int8, at
    C = FIN, untimed.  Returns the largest errors by dtype."""
    L = hub_graph()
    errs = {}
    for route, kw in (("K4", {}), ("K7", {"col_stream": False})):
        op = device_laplacian(L, fmt="bsr", device=dev, use_pallas=True,
                              **kw)
        longest = int(op.nz_rowptr.diff().max())
        check(longest > 32 and (route == "K7") != op.col_stream,
              f"long rows {route}: longest row {longest}, col_stream "
              f"{op.col_stream}")
        bf = dataclasses.replace(op, blocks=op.blocks.to(torch.bfloat16))
        for lab, o in (("f32", op), ("bf16", bf),
                       ("int8", quantize_block_sparse(op, sample_x=4.0))):
            rec = bsr_kernel_phase(o, route, ("spmm", "hop"), gen,
                                   f"long rows {route} {lab}", timed=False)
            errs[lab] = max(errs.get(lab, 0.0), rec["max_abs_err"],
                            rec["block_max_abs_err"])
    print(f"long rows (hub graph, {L.shape[0]} nodes, longest row "
          f"{longest}): K4 and K7 L@x and hop against both plain versions, "
          f"max_abs_err {errs}", flush=True)
    return errs


def print_bsr_kernel(what: str, rec: dict, gpu: str):
    def one(pre):
        r, b = rec[pre + "roofline"], rec[pre + "block_roofline"]
        return (f"{rec[pre + 'ms']:.4f} ms (plain {rec[pre + 'plain_ms']:.4f}"
                f", block plain {rec[pre + 'block_plain_ms']:.4f} ms; sparse "
                f"bound {r['bound_us'] / 1e3:.4f} ms {r['bound_by']}, block "
                f"format's work {b['bound_us'] / 1e3:.4f} ms "
                f"{b['bound_by']})")
    lib = ("none" if rec["library_ms"] is None
           else f"{rec['library_ms']:.4f} ms")
    hop = f", hop {one('hop_')}" if "hop_ms" in rec else ""
    print(f"kernel {what} C={FIN}: max_abs_err {rec['max_abs_err']:.3g} "
          f"(block plain {rec['block_max_abs_err']:.3g}), L@x {one('')}"
          f"{hop}; torch.sparse.mm {lib} [{gpu}]", flush=True)


def bsr_serve_phase(serving, reqs, kernel: str, what: str,
                    timed: bool) -> dict:
    """Serve ``reqs``: K-1 launches of ``kernel`` (K4 or a bsr_csr route)
    per request and no other BSR launch, finite [m, 16] logits, and the
    logits of the same requests through the plain twin (no launch).
    Tolerances as phase 4: 1e-4 int8, 2e-2 of the max bf16."""
    reset_bsr_launches()
    logits = [serving(x) for x in reqs]
    torch.cuda.synchronize()
    launches = {k: v for k, v in bsr_launches().items() if v}
    check(launches == {kernel: len(reqs) * (K - 1)},
          f"{what}: launches {launches} for {len(reqs)} requests")
    twin = compile_serving(map_operators(serving.model, _plain_twin),
                           serving.params, reqs[0], int8=False)
    reset_bsr_launches()
    want = [twin(x) for x in reqs]
    torch.cuda.synchronize()
    check(not any(bsr_launches().values()), f"{what}: the plain twin "
          "launched kernels")
    int8 = isinstance(serving.model.op, QuantBlockSparseLaplacian)
    err = 0.0
    for y, yp in zip(logits, want):
        check(tuple(y.shape) == (reqs[0].shape[0], CLASSES)
              and bool(torch.isfinite(y).all()), f"{what}: bad logits")
        e = float((y - yp).abs().max())
        tol = 1e-4 if int8 else 2e-2 * float(yp.abs().max())
        check(e <= tol, f"{what}: served logits off the plain twin's by "
              f"{e:.3g} (limit {tol:.3g})")
        err = max(err, e)
    rec = {"launches": launches[kernel], "max_abs_err": err,
           "serving": serving, "logits": logits}
    if timed:
        rec["ms"] = cuda_ms(lambda: serving(reqs[0]), 3)
        rec["plain_ms"] = cuda_ms(lambda: twin(reqs[0]), 1)
    return rec


def bsr_train_phase(op, data) -> dict:
    """The deep model on the bf16 colstream operator: 4 adam steps with
    72 K4 launches each, a falling loss, one step against the plain twin,
    ms per step for both."""
    dev = op.blocks.device
    model = NodeClassifier(op, FIN, CLASSES, hidden=[FIN], K=K,
                           generator=torch.Generator().manual_seed(0))
    params = _on(model.param_tree(), dev)

    def run(steps, m=model):
        return train_node_classifier(m, params, *data, steps=steps,
                                     learning_rate=LEARNING_RATE)

    torch.cuda.reset_peak_memory_stats()
    reset_bsr_launches()
    _, losses = run(TRAIN_STEPS)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    counted = bsr_launches()
    forms = dict(bsr_colstream.form_launches)
    want = {f: TRAIN_STEPS * n for f, n in BSR_STEP_FORMS.items()}
    check(counted == {"K4": TRAIN_STEPS * 3 * (K - 1)}
          and forms == want, f"bsr train: launches {counted} "
          f"{forms} for {TRAIN_STEPS} steps, want {want}")
    losses = losses.tolist()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"bsr train: losses {losses} not finite and falling")
    twin = copy.copy(model)
    twin.op = _plain_twin(op)
    loss_err, grad_err = check_step(model, twin, params, data, 2e-2,
                                    "bsr train bf16",
                                    lambda: bsr_colstream.launches)
    return {"launches": counted["K4"], "forms": forms,
            "losses": losses, "peak_gb": peak_gb, "loss_rel_err": loss_err,
            "grad_rel_err": grad_err, "run": run,
            "ms": cuda_ms(lambda: run(TRAIN_STEPS), 1) / TRAIN_STEPS,
            "plain_ms": cuda_ms(lambda: run(1, m=twin), 1)}


# ------------------------------------------- the serving artifact, phase 25


def _kernel_counts(fn) -> tuple:
    """The device kernels of one call of ``fn`` by name and count (after
    a warm-up), and the number of aten ops it called on the host (nested
    ones included), from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof, profiling.recording(ranges=True):
        fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    return ({e.key: e.count for e in _device_kernels(avg)},
            sum(e.count for e in avg if e.device_type == DeviceType.CPU
                and e.key.startswith("aten::")))


def _print_kernel_diff(what: str, compiled, loaded, x):
    """One request's device kernels of each handle, compared by name
    and count: an extra kernel in the loaded program (a copy the export
    put in) shows here."""
    (kc, oc), (kl, ol) = (_kernel_counts(lambda h=h: h(x))
                          for h in (compiled, loaded))
    diff = {k: (kc.get(k, 0), kl.get(k, 0))
            for k in sorted(set(kc) | set(kl))
            if kc.get(k, 0) != kl.get(k, 0)}
    print(f"artifact {what}: device kernels per request, compiled "
          f"{sum(kc.values())}, loaded {sum(kl.values())}; where they "
          f"differ (compiled, loaded): {diff or 'nowhere'}; aten ops on "
          f"the host, compiled {oc}, loaded {ol}", flush=True)


def artifact_subprocess_phase(model, params, reqs, want, compiled,
                              tmp: str, gpu: str) -> dict:
    """Phase 25 (a): export the int8 request of ``model``, serve
    ``reqs`` from the artifact in a fresh ``python3`` that loads it and
    builds no model (``python -m cnn_graph_tpu_torch.serve``), and hold
    its logits bit-identical to ``want`` (``compiled``'s, the
    CompiledServing of the same request, on the same requests) with K-1
    K1 launches per request and no other; then the same artifact in this
    process, and one request's device kernels of each handle compared by
    name."""
    d = os.path.join(tmp, "k1_int8")
    t0 = time.perf_counter()
    export_serving(model, params, reqs[0], d, int8=True)
    export_s = time.perf_counter() - t0
    paths = []
    for i, x in enumerate(reqs):
        paths.append(os.path.join(tmp, f"request_{i}.npy"))
        np.save(paths[-1], x.cpu().numpy())
    out = os.path.join(tmp, "k1_out")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cnn_graph_tpu_torch.serve", d, *paths,
         "--out", out],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, "the artifact's fresh process failed:\n"
          + proc.stderr[-4000:])
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    n = len(reqs)
    k1 = rec["launches"].get("band_dkw", 0)
    check(rec["launches"] == {"band_dkw": n * (K - 1)},
          f"artifact in a fresh process: launches {rec['launches']} for "
          f"{n} requests, want {n * (K - 1)} K1")
    for i, y in enumerate(want):
        got = np.load(os.path.join(out, f"out_{i}.npy"))
        check(np.array_equal(got, y.cpu().numpy()), f"artifact request {i}:"
              " loaded logits not bit-identical to CompiledServing's")
    loaded = load_serving(d)
    library.reset_launch_counts()
    y = loaded(reqs[0])
    torch.cuda.synchronize()
    check(library.launch_counts()["band_dkw"] == K - 1
          and torch.equal(y, want[0]), "artifact in this process: launches "
          f"{library.launch_counts()} or logits off CompiledServing's")
    turns = [cuda_ms(lambda f=f: f(reqs[0]), 5)
             for f in (compiled, loaded, loaded, compiled)]
    inproc_ms, compiled_ms = (turns[1] + turns[2]) / 2, (turns[0]
                                                         + turns[3]) / 2
    mib = {f: os.path.getsize(os.path.join(d, f)) / 2**20
           for f in sorted(os.listdir(d))}
    print(f"artifact 50k int8 (K1): exported in {export_s:.2f} s "
          f"({', '.join(f'{f} {v:.1f} MiB' for f, v in mib.items())}); a "
          f"fresh process loaded it in {rec['load_s']:.3f} s and served {n} "
          f"requests ({wall:.1f} s with its start), {k1} K1 launches, "
          f"logits bit-identical to CompiledServing's; request latency "
          f"there {rec['ms']:.3f} ms; in this process, in turns, loaded "
          f"{inproc_ms:.3f} ms, compiled {compiled_ms:.3f} ms [{gpu}]",
          flush=True)
    _print_kernel_diff("50k int8 (K1)", compiled, loaded, reqs[0])
    return {"launches": k1, "load_s": rec["load_s"],
            "ms": rec["ms"], "inprocess_ms": inproc_ms,
            "compiled_ms": compiled_ms, "export_s": export_s}


def artifact_phase(model, params, example, reqs, compiled, kernel: str,
                   per_request: int, int8: bool, what: str, tmp: str,
                   gpu: str) -> dict:
    """Phase 25 (b): export ``model`` as ``compiled`` serves it, load it
    in this process and serve ``reqs`` with the counts set to 0 just
    before: ``per_request`` launches of ``kernel`` a request and no
    other, as ``compiled`` launches; int8 logits bit-identical, float
    within 1e-6 of the max."""
    d = os.path.join(tmp, what.replace(" ", "_"))
    export_serving(model, params, example, d, int8=int8)
    loaded = load_serving(d)
    library.reset_launch_counts()
    got = [loaded(x) for x in reqs]
    torch.cuda.synchronize()
    launches = {k: v for k, v in library.launch_counts().items() if v}
    library.reset_launch_counts()
    want = [compiled(x) for x in reqs]
    torch.cuda.synchronize()
    n = len(reqs)
    check(launches == {kernel: per_request * n} and launches == {
        k: v for k, v in library.launch_counts().items() if v},
        f"artifact {what}: launches {launches}, compiled "
        f"{library.launch_counts()}, want {per_request * n} {kernel}")
    err = 0.0
    for y, yw in zip(got, want):
        check(y.shape == yw.shape and bool(torch.isfinite(y).all()),
              f"artifact {what}: bad logits")
        e = float((y - yw).abs().max())
        err = max(err, e)
        check(torch.equal(y, yw) if int8 else e <= 1e-6 * float(
            yw.abs().max()), f"artifact {what}: loaded logits off "
            f"CompiledServing's by {e:.3g}")
    turns = [cuda_ms(lambda f=f: f(reqs[0]), 5)
             for f in (compiled, loaded, loaded, compiled)]
    ms, cms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    print(f"artifact {what}: {n} requests, {launches.get(kernel, 0)} "
          f"{kernel} launches as compiled, max |loaded - compiled| {err:.3g}; "
          f"request latency in turns, loaded {ms:.3f} ms, compiled "
          f"{cms:.3f} ms [{gpu}]", flush=True)
    _print_kernel_diff(what, compiled, loaded, reqs[0])
    return {"launches": launches.get(kernel, 0), "ms": ms,
            "compiled_ms": cms, "max_abs_err": err}


def driver_phase(tmp: str, gpu: str) -> dict:
    """Phase 25 (c): the node-classification driver at its defaults with
    ``--int8 --export``: test accuracy above 0.5 (16 classes) and the
    int8 one within 0.05; then its artifact served on the driver's own
    features: ``DRIVER_REQUEST_K1`` K1 launches, and the int8 test
    accuracy the driver printed."""
    d = os.path.join(tmp, "driver")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m",
         "cnn_graph_tpu_torch.experiments.node_classification", "--int8",
         "--export", d], cwd=HERE, capture_output=True, text=True,
        timeout=900)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, "the node-classification driver failed:\n"
          + proc.stderr[-4000:])
    for line in proc.stdout.strip().splitlines():
        print(f"  driver: {line}")
    out = proc.stdout
    acc = re.search(r"train acc ([\d.]+) \| test acc ([\d.]+)", out)
    q = re.search(r"int8 test acc ([\d.]+) \(delta vs f32 ([-+][\d.]+)\)",
                  out)
    check(acc is not None and q is not None, "driver: no accuracy lines")
    test_acc, int8_acc = float(acc.group(2)), float(q.group(1))
    check(test_acc > 0.5 and abs(float(q.group(2))) < 0.05,
          f"driver: test accuracy {test_acc}, int8 delta {q.group(2)}")
    loaded = load_serving(d)
    check(loaded.meta["int8"] is True and loaded.meta["platforms"] ==
          ["cuda"], f"driver artifact meta {loaded.meta}")
    _, feats, labels = node_classification.build_graph(
        DRIVER_NODES, DRIVER_CLASSES, DRIVER_FEATURES, 0)
    fp, yp, _, test = node_classification.node_data(
        feats, labels, loaded.input_spec.shape[0], 0.1, 0)
    x = torch.from_numpy(fp).to(loaded.input_spec.device)
    library.reset_launch_counts()
    logits = loaded(x)
    torch.cuda.synchronize()
    launches = {k: v for k, v in library.launch_counts().items() if v}
    check(launches == {"band_dkw": DRIVER_REQUEST_K1},
          f"driver artifact: launches {launches}")
    served_acc = float((logits.argmax(1).cpu().numpy() == yp)[test].mean())
    check(f"{served_acc:.4f}" == f"{int8_acc:.4f}", f"driver artifact: "
          f"test accuracy {served_acc:.4f}, the driver's int8 {int8_acc}")
    ms = cuda_ms(lambda: loaded(x), 5)
    print(f"driver (phase 25 c): {wall:.1f} s; test acc {test_acc}, int8 "
          f"{int8_acc}; its artifact served the driver's features with "
          f"{launches.get('band_dkw', 0)} K1 launches and the same int8 "
          "accuracy, "
          f"{ms:.3f} ms per request [{gpu}]", flush=True)
    return {"launches": launches.get("band_dkw", 0), "ms": ms,
            "seconds": wall,
            "test_acc": test_acc, "int8_test_acc": int8_acc}


# ------------------------------------------------ the Trainer, phase 19


def trainer_phase(Ls, perm, dev, gpu: str, step_ms: float) -> dict:
    """Phase 19 (a): the paper's ChebNet (f32 operators, K2 and K3)
    through ``Trainer.fit`` with experiments/mnist.py's configuration,
    checkpoints and the JSONL stream in a temporary directory.  Checks
    2 K2 and 1 K3 launches per step (and 2 K2 per evaluated batch: the
    prediction and the loss each run the forward), the JSONL lines, an
    EMA that stays finite and falls, a second Trainer that resumes at
    the last step with equal parameters and runs nothing, and
    ``evaluate``/``predict`` with a ragged last batch against ``apply``.
    ``step_ms`` is phase 9's ``train_classifier`` step, printed beside."""
    splits = synthetic_mnist(n_train=TRAINER_N, n_val=TRAINER_HELD,
                             n_test=TRAINER_HELD, seed=CHEB_SEED + 1)
    data = {k: graphs.perm_data(v, perm).astype(np.float32)
            if k.endswith("_data") else v for k, v in splits.items()}
    model, _ = chebnet_model(Ls, torch.float32, dev)
    steps = TRAINER_EPOCHS * TRAINER_N // CHEB_B
    evals = steps // TRAINER_EVAL
    held_batches = -(-TRAINER_HELD // CHEB_B)
    train = (data["train_data"], data["train_labels"], data["val_data"],
             data["val_labels"])
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainConfig(
            num_epochs=TRAINER_EPOCHS, learning_rate=LEARNING_RATE,
            decay_rate=0.95, decay_steps=TRAINER_N // CHEB_B,
            batch_size=CHEB_B, eval_frequency=TRAINER_EVAL, seed=CHEB_SEED,
            checkpoint_dir=os.path.join(tmp, "ckpt"),
            log_path=os.path.join(tmp, "metrics.jsonl"))
        trainer = Trainer(model, cfg, task="classification")
        reset_cheby_launches()
        t0 = time.perf_counter()
        hist, val_losses, t_step = trainer.fit(*train, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = cheby_launches()
        want = (2 * steps + 2 * evals * held_batches, steps)
        check(launches == want, f"trainer: launches (K2, K3) {launches}, "
              f"want {want} for {steps} steps and {evals} evaluations")
        lines = [json.loads(s) for s in open(cfg.log_path)]
        logged = lines[1:-1]
        check(lines[0] == {"event": "start", "run": "run"}
              and lines[-1] == {"event": "end"}
              and [r["step"] for r in logged]
              == list(range(TRAINER_EVAL, steps + 1, TRAINER_EVAL))
              and all(list(r) == ["step", "time", "loss_ema", "val_metric",
                                  "val_loss"] for r in logged)
              and [r["val_metric"] for r in logged] == hist
              and [r["val_loss"] for r in logged] == val_losses,
              f"trainer: JSONL lines {lines}")
        ema = [r["loss_ema"] for r in logged]
        check(all(np.isfinite(ema)) and ema[-1] < ema[0],
              f"trainer: EMA {ema} not finite and falling")
        saved = CheckpointManager(cfg.checkpoint_dir).all_steps()
        check(saved == [r["step"] for r in logged],
              f"trainer: checkpoints at {saved}")
        resumed = Trainer(model, cfg, task="classification")
        reset_cheby_launches()
        resumed.fit(*train, verbose=False)
        torch.cuda.synchronize()
        check(cheby_launches() == (0, 0)
              and int(resumed.opt_state["count"]) == steps
              and all(torch.equal(a, b) for a, b in zip(
                  tree_leaves(resumed.params), tree_leaves(trainer.params))),
              "trainer: the resumed Trainer's state differs from the first's")
    reset_cheby_launches()
    string, metrics = trainer.evaluate(data["test_data"],
                                       data["test_labels"])
    torch.cuda.synchronize()
    check(cheby_launches() == (2 * held_batches, 0)
          and len(metrics["predictions"]) == TRAINER_HELD,
          f"trainer: evaluate launched {cheby_launches()}")
    logits = trainer.predict(data["test_data"])
    x = torch.from_numpy(data["test_data"]).to(dev)
    last = x.new_zeros((CHEB_B,) + x.shape[1:])
    tail = TRAINER_HELD - (held_batches - 1) * CHEB_B
    last[:tail] = x[TRAINER_HELD - tail:]
    with torch.inference_mode():
        direct = torch.cat([model.apply(trainer.params, x[:CHEB_B]),
                            model.apply(trainer.params, last)[:tail]])
    got = torch.from_numpy(np.concatenate([logits[:CHEB_B],
                                           logits[-tail:]]))
    diff = float((got - direct.cpu()).abs().max())
    check(logits.shape == (TRAINER_HELD, CHEB["M"][-1])
          and np.isfinite(logits).all()
          and diff <= 1e-5 * float(direct.abs().max()),
          f"trainer: predict off apply on its batches by {diff:.3g}")
    gen = torch.Generator(device=dev).manual_seed(0)
    xb = torch.from_numpy(data["train_data"][:CHEB_B]).to(dev)
    yb = torch.from_numpy(data["train_labels"][:CHEB_B]).to(dev)
    ema0 = torch.tensor(-1.0, device=dev)

    def run(n_steps):
        for _ in range(n_steps):
            trainer._train_step(trainer.params, trainer.opt_state, ema0, gen,
                                xb, yb)

    ms = cuda_ms(lambda: run(1), 10)
    print(f"trainer chebnet f32 (phase 19): Trainer.fit {steps} steps of "
          f"{CHEB_B} in {fit_s:.1f} s, launches (K2, K3) {launches} = "
          f"(2, 1) per step + (2, 0) per evaluated batch; EMA "
          f"{[round(v, 4) for v in ema]}; validation accuracy {hist}; "
          f"checkpoints {saved}, resumed at step {steps} with equal "
          f"parameters; test {string}; ms per step: fit's t_step "
          f"{1e3 * t_step:.3f} (evaluations and checkpoints included), "
          f"CUDA events {ms:.3f} (Trainer step), phase 9's "
          f"train_classifier {step_ms:.3f} [{gpu}]", flush=True)
    return {"launches": launches, "steps": steps,
            "eval_launches": 2 * evals * held_batches,
            "t_step_ms": 1e3 * t_step, "ms": ms, "run": run}


def text_trainer_phase(gpu: str):
    """Phase 19 (b): experiments/text20news.py --synthetic, GC32 for
    ``TEXT_EPOCHS`` epochs on the card through ``Trainer.fit``.  Its
    layer has Fin = 1, which ``_fused_eligible`` refuses: the stacked
    route, no K2 or K3."""
    reset_cheby_launches()
    t0 = time.perf_counter()
    metrics, t_step = text20news.main(["--synthetic", "--epochs",
                                       str(TEXT_EPOCHS)])
    torch.cuda.synchronize()
    check(cheby_launches() == (0, 0) and np.isfinite(metrics["loss"])
          and 0 <= metrics["accuracy"] <= 100,
          f"text20news: launches {cheby_launches()}, metrics {metrics}")
    print(f"text20news GC32 (phase 19): {TEXT_EPOCHS} epochs through "
          f"Trainer.fit, test accuracy {metrics['accuracy']:.2f}%, "
          f"{1e3 * t_step:.3f} ms per step (fit's t_step), "
          f"{time.perf_counter() - t0:.1f} s with the text set-up [{gpu}]",
          flush=True)


# ------------------------------- flow forecasting and the filters, 22-24


def flow_data():
    """Phase 22's data: ``synthetic_flow(n_nodes=1024, n_steps=1400,
    seed=0)`` written as experiments/humanflow.py's ``build_dataset``
    writes it, loaded with ``load_ln_data_period(4, 1, 1)`` (train [672,
    1024, 12], validation and test [168, 1024, 12]) and, for the per-node
    LSTM, ``load_lstm_data``.  Returns the HumanTraffic instance (its
    scale undoes the normalization), the splits, the normalized
    Laplacian, the stacked per-node series and the host set-up
    seconds."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        humanflow.write_synthetic(tmp, FLOW_NODES, FLOW_SEED)
        ht = HumanTraffic(tmp)
        *splits, edges = ht.load_ln_data_period(FLOW_SEQ, 1, 1)
        lstm = stack_lstm_collection(HumanTraffic(tmp).load_lstm_data(
            FLOW_SEQ, 0, "ln_data.mat"))
    L = graphs.laplacian(scipy.sparse.csr_matrix(edges), normalized=True)
    return {"ht": ht, "splits": [a.astype(np.float32) for a in splits],
            "L": L, "lstm": lstm, "setup_s": time.perf_counter() - t0}


def flow_fit(model, train, held, steps: int, evals: int, what: str,
             per_step=(0, 0), per_forward: int = 0,
             falling: bool = True) -> dict:
    """``Trainer(task="regression").fit`` for ``steps`` steps with
    ``evals`` evaluations of ``held`` (experiments/humanflow.py's
    configuration: lr 1e-3, decay 0.95 every epoch, batch 50), the JSONL
    stream in a temporary directory.  Checks the K2 and K3 launches of
    the fit, ``per_step`` a training step and ``per_forward`` K2 a
    forward (an evaluated batch runs two: the prediction and the loss),
    and an EMA that stays finite and, with ``falling``, falls.  Then times one step
    (``Trainer._train_step``, CUDA events) on the first batch and checks
    its launches alone."""
    n = train[0].shape[0]
    held_batches = -(-held[0].shape[0] // FLOW_B)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainConfig(
            num_epochs=(steps + 0.5) * FLOW_B / n, learning_rate=FLOW_LR,
            decay_rate=0.95, decay_steps=max(n // FLOW_B, 1),
            batch_size=FLOW_B, eval_frequency=-(-steps // evals),
            seed=FLOW_SEED, log_path=os.path.join(tmp, "metrics.jsonl"))
        trainer = Trainer(model, cfg, task="regression")
        reset_cheby_launches()
        t0 = time.perf_counter()
        hist, _, t_step = trainer.fit(*train, *held, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = cheby_launches()
        logged = [json.loads(s) for s in open(cfg.log_path)][1:-1]
    want = (per_step[0] * steps + 2 * evals * held_batches * per_forward,
            per_step[1] * steps)
    check(len(logged) == evals and launches == want,
          f"{what}: {len(logged)} evaluations, launches (K2, K3) "
          f"{launches}; want {evals} and {want} for {steps} steps")
    ema = [r["loss_ema"] for r in logged]
    check(all(np.isfinite(ema)) and (ema[-1] < ema[0] or not falling),
          f"{what}: EMA {ema} not finite and falling")
    dev = trainer.device
    xb = torch.from_numpy(train[0][:FLOW_B]).to(dev)
    yb = torch.from_numpy(train[1][:FLOW_B]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ema0 = torch.tensor(-1.0, device=dev)

    def run(n_steps):
        for _ in range(n_steps):
            trainer._train_step(trainer.params, trainer.opt_state, ema0, gen,
                                xb, yb)

    run(1)
    reset_cheby_launches()
    run(1)
    torch.cuda.synchronize()
    check(cheby_launches() == tuple(per_step),
          f"{what}: one step launched (K2, K3) {cheby_launches()}, want "
          f"{tuple(per_step)}")
    return {"trainer": trainer, "launches": launches, "steps": steps,
            "eval_launches": want[0] - per_step[0] * steps, "ema": ema,
            "hist": hist, "fit_s": fit_s, "t_step_ms": 1e3 * t_step,
            "ms": cuda_ms(lambda: run(1), 5), "run": run}


def flow_phase(flow: dict, dev, gpu: str) -> dict:
    """Phase 22: flow forecasting on 1,024 regions at experiments/
    humanflow.py's widths.
    (a) ResGNN (K=2, nfilter 64, nres 4) through ``Trainer.fit`` for 2
    epochs on the fused dense operator: 16 K2 and 8 K3 launches a step,
    one step's loss and gradients against the plain twin within 1e-3,
    ``evaluate`` and its RMSE and MAPE in real units; the same step on
    the operator humanflow.py builds by default (``use_pallas`` unset, the
    stacked route as in JAX), timed beside.  (b) GConvForecaster
    glstm_gconv (H 64, Hc 32, K=2) for 10 steps with its gLSTM dropout:
    25 K2 and 13 K3 a step, the same checks.  (c) ResGNN with the Fourier
    filter and the per-node LSTM, no kernel: a few steps, finite losses,
    ms per step."""
    ht, splits, L, lstm = (flow[k] for k in ("ht", "splits", "L", "lstm"))
    tr, va, te, trl, val, tel = splits
    check(tr.shape == (672, FLOW_NODES, 12) and va.shape == te.shape
          == (168, FLOW_NODES, 12), f"flow splits {[a.shape for a in splits]}")
    op = device_laplacian(L, device=dev, use_pallas=True)
    stacked_op = device_laplacian(L, device=dev)
    for o in (op, stacked_op):
        check(isinstance(o, DenseLaplacian) and o.m == FLOW_NODES
              and o.mat.dtype == torch.float32,
              f"flow operator {type(o).__name__} {o.m} {o.mat.dtype}")
    check(op.use_fused and not stacked_op.use_fused, "flow operators' route")
    print(f"flow data (phase 22): synthetic_flow({FLOW_NODES} regions, "
          f"{FLOW_STEPS} steps), load_ln_data_period({FLOW_SEQ}, 1, 1): "
          f"train {tr.shape}, validation {va.shape}, test {te.shape}; "
          f"{L.nnz} nonzeros, a {op.m}-node f32 DenseLaplacian; per-node "
          f"series {lstm['train_data'].shape}; host set-up "
          f"{flow['setup_s']:.1f} s",
          flush=True)
    train, held = (tr, trl), (va, val)
    rec = {}
    gen = torch.Generator().manual_seed(FLOW_SEED)
    batch = (torch.from_numpy(tr[:FLOW_B]).to(dev),
             torch.from_numpy(trl[:FLOW_B]).to(dev))

    # (a) ResGNN.
    model = ResGNN(op, 12, **RESGNN, generator=gen)
    steps = int(RESGNN_EPOCHS * tr.shape[0] / FLOW_B)
    r = rec["resgnn"] = flow_fit(model, train, held, steps, 2, "resgnn",
                                 RESGNN_STEP_LAUNCHES, RESGNN_FWD_K2)
    twin = copy.copy(model)
    twin.op = _plain_dense(op)
    params = _on(r["trainer"].params, dev)
    r["loss_rel_err"], r["grad_rel_err"] = check_step(
        model, twin, params, batch, 1e-3, "resgnn",
        lambda: sum(cheby_launches()))
    reset_cheby_launches()
    string, metrics = r["trainer"].evaluate(te, tel)
    torch.cuda.synchronize()
    held_batches = -(-te.shape[0] // FLOW_B)
    check(cheby_launches() == (2 * held_batches * RESGNN_FWD_K2, 0)
          and np.isfinite(metrics["predictions"]).all(),
          f"resgnn: evaluate launched {cheby_launches()}")
    preds = ht.reverse_normalize(metrics["predictions"])
    targets = ht.reverse_normalize(tel)
    r["rmse"], r["mape"] = rmse(targets, preds), mape(targets, preds)
    stacked = copy.copy(model)
    stacked.op = stacked_op
    r["stacked_ms"] = cuda_ms(lambda: loss_and_grads(
        stacked, params, batch, seed=0), 5)
    r["step_ms"] = cuda_ms(lambda: loss_and_grads(model, params, batch,
                                                  seed=0), 5)
    print(f"flow resgnn (phase 22a): Trainer.fit {steps} steps of {FLOW_B} "
          f"in {r['fit_s']:.1f} s, launches (K2, K3) {r['launches']} = "
          f"{RESGNN_STEP_LAUNCHES} per step + ({r['eval_launches']}, 0) in "
          f"2 evaluations; EMA {[round(v, 5) for v in r['ema']]}; one step "
          f"vs plain: loss rel err {r['loss_rel_err']:.3g}, gradient err "
          f"{r['grad_rel_err']:.3g} of max; test {string}; RMSE "
          f"{r['rmse']:.4f}, MAPE {r['mape']:.4f} (real units); ms per "
          f"step: CUDA events {r['ms']:.3f} (Trainer step), fit's t_step "
          f"{r['t_step_ms']:.3f}; loss and gradients alone: fused "
          f"{r['step_ms']:.3f}, the stacked route (use_pallas unset) "
          f"{r['stacked_ms']:.3f} [{gpu}]", flush=True)

    # (b) glstm_gconv, its gLSTM output dropout on.
    model = GConvForecaster(op, FLOW_SEQ, 1, 1, variant="glstm_gconv",
                            num_hidden=64, K=2, generator=gen)
    g = rec["glstm"] = flow_fit(model, train, held, GLSTM_STEPS, 2,
                                "glstm_gconv", GLSTM_STEP_LAUNCHES,
                                GLSTM_FWD_K2)
    twin = copy.copy(model)
    twin.op = _plain_dense(op)
    g["loss_rel_err"], g["grad_rel_err"] = check_step(
        model, twin, _on(g["trainer"].params, dev), batch, 1e-3,
        "glstm_gconv", lambda: sum(cheby_launches()))
    string, metrics = g["trainer"].evaluate(te, tel)
    preds = ht.reverse_normalize(metrics["predictions"])
    g["rmse"], g["mape"] = rmse(targets, preds), mape(targets, preds)
    print(f"flow glstm_gconv (phase 22b): {model.to_string()}: Trainer.fit "
          f"{GLSTM_STEPS} steps in {g['fit_s']:.1f} s, launches (K2, K3) "
          f"{g['launches']} = {GLSTM_STEP_LAUNCHES} per step + "
          f"({g['eval_launches']}, 0) in 2 evaluations; EMA "
          f"{[round(v, 5) for v in g['ema']]}; one step vs plain (dropout "
          f"masks from one seed): loss rel err {g['loss_rel_err']:.3g}, "
          f"gradient err {g['grad_rel_err']:.3g} of max; test {string}; "
          f"RMSE {g['rmse']:.4f}, MAPE {g['mape']:.4f}; ms per step: CUDA "
          f"events {g['ms']:.3f}, fit's t_step {g['t_step_ms']:.3f} [{gpu}]",
          flush=True)

    # (c) No kernel: ResGNN with the Fourier filter, and the per-node LSTM.
    U = graphs.fourier(L)[1]
    model = ResGNN(op, 12, **RESGNN, filter="fourier", fourier_u=U,
                   generator=gen)
    f = rec["fourier"] = flow_fit(model, train, held, FLOW_FEW_STEPS, 2,
                                  "resgnn fourier", falling=False)
    model = PerNodeLSTM(FLOW_NODES, FLOW_SEQ, num_hidden=64, generator=gen,
                        device=dev)
    lt = rec["lstm"] = flow_fit(
        model, (lstm["train_data"], lstm["train_labels"]),
        (lstm["test_data"], lstm["test_labels"]), FLOW_FEW_STEPS, 2, "lstm",
        falling=False)
    for name, x in (("resgnn fourier", f), ("per-node lstm", lt)):
        string, metrics = x["trainer"].evaluate(*(
            (te, tel) if name != "per-node lstm"
            else (lstm["test_data"], lstm["test_labels"])))
        check(np.isfinite(metrics["loss"]), f"{name}: test loss")
        print(f"flow {name} (phase 22c): {FLOW_FEW_STEPS} Trainer steps, "
              f"EMA {[round(v, 5) for v in x['ema']]}, test {string}; "
              f"{x['ms']:.3f} ms per step (CUDA events), fit's t_step "
              f"{x['t_step_ms']:.3f} [{gpu}]", flush=True)
    return rec


def flow_kernel_phase(L, dev, gen, gpu: str) -> dict:
    """Phase 23: K2 and K3 at the forecasting models' geometries on the
    1,024-region operator at B = 50, K = 2, in f32 and bf16, against their
    plain versions with phase 7's tolerances, each timed by device work
    beside its bound and printed with its launch geometry."""
    rec = {}
    for lab, dt in DTYPES.items():
        tol = 1e-4 if lab == "f32" else 1e-2
        op = device_laplacian(L, fmt="dense", dtype=dt, device=dev,
                              use_pallas=True)
        for kernel, shapes in (("K2", FLOW_K2_SHAPES),
                               ("K3", FLOW_K3_SHAPES)):
            for name, (F, O) in shapes.items():
                x = torch.randn(FLOW_B, op.m, F, generator=gen, device=dev)
                if kernel == "K2":
                    w = 0.05 * torch.randn(2, F, O, generator=gen,
                                           device=dev)
                    pair = (lambda: fused_filter(x, op, w),
                            lambda: cheby_conv_fused_reference(x, op, w))
                else:
                    g = torch.randn(FLOW_B, op.m, O, generator=gen,
                                    device=dev)
                    pair = (lambda: cheby_dw_fused(x, op, g, 2),
                            lambda: cheby_dw_fused_reference(x, op, g, 2))
                r = rec[f"{lab}_{kernel}_{name}"] = {
                    **_kernel_vs_plain(*pair, tol, f"{kernel} {lab} {name}",
                                       timer=device_ms),
                    "bound": dense_cheby_bound(op, FLOW_B, F, O, 2),
                    "geometry": _fitted_geometry(kernel, lab, name, FLOW_B,
                                                 op, F, O)}
                geo = r["geometry"]
                print(f"kernel {kernel} {lab} flow {name} (phase 23) x "
                      f"[{FLOW_B}, {op.m}, {F}], K=2: max_abs_err "
                      f"{r['max_abs_err']:.3g} (of max {r['scale']:.3g}), "
                      f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms; "
                      f"bound {r['bound']['bound_us'] / 1e3:.4f} ms "
                      f"{r['bound']['bound_by']}); np {geo['np']}, nop "
                      f"{geo['nop']}, {geo['samples']} samples a group, "
                      f"{geo['groups']} clusters of {geo['cluster']} CTAs, "
                      f"{geo['rows']}-row tiles, {geo['smem']} B shared "
                      f"memory, {geo['resident_clusters']} clusters at once "
                      f"[{gpu}]", flush=True)
    return rec


def filters_phase(Ls, data, dev, gpu: str) -> dict:
    """Phase 24 (a): the paper's other filters on the MNIST grid's
    operators, ChebNet built as experiments/mnist.py builds it (F=[32,
    64], K=[25, 25], dropout 0.5, L2 5e-4).  For each of fourier, spline
    and lanczos: 8 adam steps through ``train_classifier`` on one batch of
    100 (3 land in Adam's first overshoot), finite losses whose last is
    under the first and an evaluation loss that falls; one step's loss and
    gradients (dropout off) on the card against the same step on the CPU:
    loss within 1e-4, gradients within 1e-3 of their max, Lanczos's
    within 5e-2 (its gradient passes through ``eigh`` of 25 x 25 Krylov
    matrices: f32 and float64 on the CPU alone differ by 9.0e-3 of the
    max).  None of the three runs a kernel."""
    x = torch.from_numpy(data["train_data"]).to(dev)
    y = torch.from_numpy(data["train_labels"]).to(dev)
    rec = {}
    for filt in FILTERS:
        ops = {d: [device_laplacian(L, device=d) for L in Ls]
               for d in (dev, "cpu")}
        model = ChebNet(ops[dev], **CHEB, laplacians=Ls, filter=filt,
                        generator=torch.Generator().manual_seed(0))
        params = _on(model.param_tree(), dev)
        reset_cheby_launches()
        with torch.no_grad():
            before = float(model.loss(params, x, y))
        trained, losses = train_classifier(
            model, params, x, y, batch_size=CHEB_B, steps=FILTER_STEPS,
            learning_rate=LEARNING_RATE,
            generator=torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            after = float(model.loss(trained, x, y))
        torch.cuda.synchronize()
        losses = losses.tolist()
        check(cheby_launches() == (0, 0) and all(np.isfinite(losses))
              and losses[-1] < losses[0] and after < before,
              f"chebnet {filt}: losses {losses}, evaluation loss {before} -> "
              f"{after}, launches {cheby_launches()}")
        cpu = ChebNet(ops["cpu"], **CHEB, laplacians=Ls, filter=filt,
                      generator=torch.Generator().manual_seed(0))
        out = []
        for m, d in ((model, dev), (cpu, "cpu")):
            p = tree_map(lambda t: t.detach().to(d).requires_grad_(),
                         trained)
            loss = m.loss(p, x.to(d), y.to(d))
            loss.backward()
            out.append((float(loss.detach()),
                        [t.grad.cpu() for t in tree_leaves(p)]))
        (loss, grads), (loss_c, grads_c) = out
        tol = 5e-2 if filt == "lanczos" else 1e-3
        grad_err = max(float((a - b).abs().max())
                       / max(float(b.abs().max()), 1e-30)
                       for a, b in zip(grads, grads_c))
        loss_err = abs(loss - loss_c) / abs(loss_c)
        check(loss_err <= 1e-4 and grad_err <= tol,
              f"chebnet {filt}: card vs CPU loss {loss_err:.3g}, gradients "
              f"{grad_err:.3g} of max (limit {tol})")
        ms = cuda_ms(lambda: train_classifier(
            model, trained, x, y, batch_size=CHEB_B, steps=1,
            learning_rate=LEARNING_RATE,
            generator=torch.Generator(device=dev).manual_seed(1)), 3)
        rec[filt] = {"losses": losses, "ms": ms, "grad_err": grad_err}
        print(f"chebnet {filt} (phase 24a): {FILTER_STEPS} adam steps, "
              f"losses {[round(v, 4) for v in losses]}, evaluation loss "
              f"{before:.4f} -> {after:.4f}; one step vs the CPU: loss rel "
              f"err {loss_err:.3g}, gradient err {grad_err:.3g} of max; "
              f"{ms:.3f} ms per step, no kernel launch [{gpu}]", flush=True)
    return rec


def lanczos_k1_phase(op, gen, gpu: str) -> dict:
    """Phase 24 (b): ``lanczos_conv`` at K=5, B=2, Fin=16 on the f32 copy
    of the 50,176-node deep-K-window operator, its ``L @ v`` products
    through K1: K launches a call (K-1 in the recurrence, one for the last
    diagonal term), the basis within 1e-3 of the plain operator's max."""
    x = torch.randn(2, op.m, 16, generator=gen, device=op.base.device)
    w = 0.1 * torch.randn(LANCZOS_K, 16, 8, generator=gen,
                          device=op.base.device)
    plain = _plain_banded(op)
    reset_band_launches()
    with torch.no_grad():
        basis = lanczos_basis_device(x, op, LANCZOS_K)
        torch.cuda.synchronize()
        launches = banded_dkw.launches
        check(launches == LANCZOS_K and sum(band_launches().values())
              == launches, f"lanczos: {band_launches()} launches, want "
              f"{LANCZOS_K} of K1")
        want = lanczos_basis_device(x, plain, LANCZOS_K)
        err = float((basis - want).abs().max())
        scale = float(want.abs().max())
        check(bool(torch.isfinite(basis).all()) and err <= 1e-3 * scale,
              f"lanczos: max |kernel - plain| {err:.3g} of {scale:.3g}")
        ms = cuda_ms(lambda: lanczos_conv(x, op, w), 5)
        plain_ms = cuda_ms(lambda: lanczos_conv(x, plain, w), 2)
    print(f"lanczos_conv (phase 24b) K={LANCZOS_K}, x [2, {op.m}, 16] on the "
          f"f32 dkw operator: {launches} K1 launches, basis max_abs_err "
          f"{err:.3g} (of max {scale:.3g}); {ms:.3f} ms per call (plain "
          f"operator {plain_ms:.3f} ms) [{gpu}]", flush=True)
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


# --------------------------------------- the 20NEWS topology cell, phase 20


def news_graph():
    """bench.py:637-650: the 20NEWS-shape 10k-word embedding-kNN graph,
    RCM-ordered, its normalized Laplacian.  Also returns how many words
    have an identical twin embedding (where the tree kNN and JAX's
    scikit-learn kNN may order neighbours differently) and the seconds
    the host took."""
    t0 = time.perf_counter()
    ds = synthetic_text_dataset(n_docs=NEWS_DOCS, vocab_size=NEWS_VOCAB,
                                seed=0)
    ds.clean_text()
    ds.vectorize()
    ds.remove_short_documents(nwords=5)
    ds.keep_top_words(NEWS_WORDS, Mprint=0)
    ds.embed(size=NEWS_DIM, seed=0)
    dist, idx = graphs.knn(ds.embeddings.astype(np.float32), k=NEWS_KNN,
                           algorithm="auto")
    W = graphs.adjacency(dist, idx)
    perm = graphs.bandwidth_reducing_permutation(W)
    W = W[perm][:, perm].tocsr()
    return (graphs.laplacian(W, normalized=True),
            int((dist[:, 0] == 0).sum()), time.perf_counter() - t0)


def news_phase(dev, gpu: str):
    """Phase 20: the 10,000-node graph served as a ``DenseLaplacian`` in
    bf16 (the format JAX chose), its K=5 chains in bf16 (against the
    same chain in f32 on the f32 copy of the bf16 matrix, within 2e-2 of
    the max) and int8 (the int32 ``_int_mm`` accumulator against the
    float64 one, bit-identical), each timed by ``slope_time``, and the
    planted-partition NodeClassifier's float and int8 accuracy."""
    L, twins, setup = news_graph()
    op = device_laplacian(L, fmt="auto", dtype=torch.bfloat16, device=dev)
    check(isinstance(op, DenseLaplacian) and op.m == NEWS_WORDS,
          f"20news: auto format gave {type(op).__name__} of {op.m} nodes")
    qop = quantize_dense(op, sample_x=3.0)
    print(f"20news graph (phase 20): {op.m} nodes, nnz {op.nnz} (JAX's "
          f"graph {NEWS_JAX_NNZ}), {twins} words with a twin embedding, "
          f"{type(op).__name__} {op.m_padded}^2 bf16; set-up {setup:.1f} s",
          flush=True)
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(op.m_padded, FIN))).to(
        dev, torch.bfloat16)
    ref = DenseLaplacian(mat=op.mat.float(), m=op.m, m_padded=op.m_padded,
                         nnz=op.nnz)
    plain_q = _plain_twin(qop)
    got = make_chain(op, 1, NEWS_K)(X)
    want = make_chain(ref, 1, NEWS_K)(X.float())
    err = float((got - want).abs().max())
    check(err <= 2e-2 * float(want.abs().max()), f"20news bf16 chain off "
          f"the f32 copy's by {err:.3g}")
    print(f"20news bf16 chain: max |bf16 - f32 chain| {err:.3g} of "
          f"{float(want.abs().max()):.3g}", flush=True)
    got_q, want_q = (make_chain(o, 1, NEWS_K)(X) for o in (qop, plain_q))
    check(torch.equal(got_q, want_q), "20news int8 chain: the int32 "
          "accumulator differs from the float64 one")
    for lab, o in (("bf16", op), ("int8", qop), ("int8_f64", plain_q)):
        per, _ = slope_time(lambda u, o=o: make_chain(o, u, NEWS_K), (X,),
                            units=NEWS_UNITS)
        dt = per / (NEWS_K - 1)
        print(f"20news chain {lab} K={NEWS_K} C={FIN}: {dt * 1e6:.2f} us "
              f"per SpMM, {op.nnz / dt / 1e9:.4f} Gedges/s [{gpu}]",
              flush=True)
    # bench.py:697-741: labels by node index, a class signature plus
    # unit noise, 10% of the nodes labelled; trained on the bf16 operator.
    m, mp = op.m, op.m_padded
    labels = (np.arange(m) * NEWS_CLASSES // m).astype(np.int64)
    sig = rng.normal(0, 1, (NEWS_CLASSES, NEWS_FIN)).astype(np.float32)
    feats = sig[labels] + rng.normal(0, 1.0, (m, NEWS_FIN)).astype(
        np.float32)
    fp = np.zeros((mp, NEWS_FIN), np.float32)
    fp[:m] = feats
    yp = np.zeros((mp,), np.int64)
    yp[:m] = labels
    train = np.zeros(mp, bool)
    train[:m] = rng.random(m) < 0.1
    test = np.zeros(mp, bool)
    test[:m] = ~train[:m]
    f, y, tm, em = (torch.from_numpy(a).to(dev) for a in (fp, yp, train,
                                                          test))
    model = NodeClassifier(op, NEWS_FIN, NEWS_CLASSES, hidden=[], K=NEWS_K,
                           generator=torch.Generator().manual_seed(0))
    params, losses = train_node_classifier(
        model, model.param_tree(), f, y, tm, steps=NEWS_STEPS,
        learning_rate=NEWS_LR)
    losses = losses.tolist()
    check(np.isfinite(losses[-1]) and losses[-1] < losses[0],
          f"20news: adam losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    with torch.inference_mode():
        acc = {lab: float(map_operators(model, lambda _, o=o: o).accuracy(
            params, f, y, em)) for lab, o in (("f32", op), ("int8", qop))}
    check(acc["f32"] >= 0.9 and abs(acc["int8"] - acc["f32"]) <= 0.01,
          f"20news accuracy: {acc}")
    print(f"20news NodeClassifier: {NEWS_STEPS} adam steps on the bf16 "
          f"operator, loss {losses[0]:.4f} -> {losses[-1]:.4f}; test "
          f"accuracy float {acc['f32']:.4f}, int8 {acc['int8']:.4f} "
          f"(delta {acc['int8'] - acc['f32']:+.4f}) [{gpu}]", flush=True)


# ------------------------------------- the 50k scattered K=25 chain, phase 21


def bsr_chain_phase(op, X, what: str, gpu: str, lib_ms=None) -> dict:
    """bench.py's 50k scattered chain on BSR: K-1 K4 launches per K-block
    and no other, the int8 chain bit-identical to the plain twin's and
    bf16 within 2e-2 of its max (one K-block), then us per SpMM by slope
    fit over ``SCAT_CHAIN_UNITS``, ns per block, Gedges/s and the sparse
    bound of the hop, beside phase 16's ``torch.sparse.mm`` (``lib_ms``,
    one L@x)."""
    reset_bsr_launches()
    got = make_chain(op, 1)(X)
    torch.cuda.synchronize()
    launches = bsr_launches()
    check(launches["K4"] == K - 1 and sum(launches.values()) == K - 1,
          f"chain {what}: launches {launches}, want {K - 1} of K4")
    want = make_chain(_plain_twin(op), 1)(X)
    torch.cuda.synchronize()
    check(sum(bsr_launches().values()) == K - 1,
          f"chain {what}: the plain chain launched kernels")
    err = float((got - want).abs().max())
    if op.compute_dtype == torch.int8:
        check(torch.equal(got, want), f"chain {what}: int8 chain not "
              "bit-identical to the plain chain")
    else:
        check(err <= 2e-2 * float(want.abs().max()), f"chain {what}: off "
              f"the plain chain by {err:.3g}")
    per, fixed = slope_time(lambda u: make_chain(op, u), (X,),
                            units=SCAT_CHAIN_UNITS)
    t = per / (K - 1)
    nb = op.block_cols.numel()
    roof = sparse_roofline(op, t, X.shape[1], extra_inputs=1)
    rec = {"launches": launches["K4"], "us_per_spmm": t * 1e6,
           "ns_per_block": t / nb * 1e9, "gedges_per_s": op.nnz / t / 1e9,
           "max_abs_err": err, "roofline": roof}
    lib = "" if lib_ms is None else f"; torch.sparse.mm L@x {lib_ms:.4f} ms"
    print(f"chain {what} (K4) K={K} C={X.shape[1]}: {rec['us_per_spmm']:.2f} "
          f"us per SpMM, {rec['ns_per_block']:.2f} ns per block ({nb} "
          f"blocks), {rec['gedges_per_s']:.4f} Gedges/s, "
          f"{roof['achieved_frac_of_bound']:.3f} of the {roof['bound_by']} "
          f"bound {roof['bound_us']:.2f} us{lib}; max |kernel - plain| "
          f"{err:.3g} [{gpu}]", flush=True)
    return rec


# ------------------------------------------- the int8 conversions, phase 29

QUANT_SOURCE = "cnn_graph_tpu_torch/csrc/quant.cu"
# What the JAX package has in their place: the int8 twins' conversions,
# left to XLA, which fuses them into their neighbours (no kernel).
QUANT_REPLACES = "cnn_graph_tpu/ops/laplacian.py:95 (QuantOpMixin, XLA)"
QUANT_ROWS, QUANT_COLS = 50_176, FIN  # the 50k request's carries


def quant_launches() -> tuple:
    return quant.quantize_int8.launches, quant.dequantize_int8.launches


def reset_quant_launches():
    torch.cuda.synchronize()
    quant.quantize_int8.launches = quant.dequantize_int8.launches = 0


def conversion_phase(dev, gpu: str) -> dict:
    """Phase 29: each conversion bit-equal to its plain expression called
    directly, one launch a call, then timed.  Keys ``quant_<x dtype>_
    <scale>`` and ``dequant_<out dtype>_<scale>``, scale ``device`` or
    ``float``: ``ms``, ``plain_ms``, ``bound_ms`` (the bytes of its
    elements at 3.35 TB/s: the int8 side 1 B, the float side 4 or 2) and,
    for the dequantisation, ``library_ms`` (``torch.mul(q, s)``, into a
    bf16 ``out`` for bf16)."""
    gen = torch.Generator(device=dev).manual_seed(29)
    x32 = 3.0 * torch.randn(QUANT_ROWS, QUANT_COLS, generator=gen,
                            device=dev)
    # A device scale that sends the tails past +-127, as the int8 convs
    # compute theirs on the card; a float one that sends more past it.
    scales = {"device": torch.clamp_min(x32.abs().amax(), 1e-30)
              * torch.tensor(0.5 / 127.0, device=dev), "float": 0.05}
    n, out = x32.numel(), {}

    def one(name, kernel, plain, library, nbytes):
        got, want = kernel(), plain()
        check(torch.equal(got, want) and got.dtype == want.dtype,
              f"{name}: kernel differs from the plain expression")
        before = sum(quant_launches())
        kernel()
        torch.cuda.synchronize()
        check(sum(quant_launches()) - before == 1,
              f"{name}: {sum(quant_launches()) - before} launches a call")
        rec = {"ms": device_ms(kernel, 50), "plain_ms": device_ms(plain, 50),
               "bound_ms": nbytes / profiling.H100_BYTES_PER_S * 1e3,
               "bound_by": "bytes"}
        if library is not None:
            check(torch.equal(library(), want),
                  f"{name}: the library call differs from the plain one")
            rec["library_ms"] = device_ms(library, 50)
        out[name] = rec
        print(f"kernel {name} [{QUANT_ROWS}, {QUANT_COLS}]: "
              f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
              + (f"torch.mul {rec['library_ms']:.4f}, "
                 if library is not None else "")
              + f"bound {rec['bound_ms']:.4f} by bytes, "
              f"{rec['bound_ms'] / rec['ms']:.3f} of it); bit-equal "
              f"[{gpu}]", flush=True)

    q = quant.quantize_reference(x32, scales["device"])
    check(int(q.abs().max()) == 127 and bool(
        ((x32 / scales["device"]).abs() > 127.5).any()),
          "conversions: no value past +-127 at the device scale")
    for lab, dt in DTYPES.items():
        x = x32.to(dt)
        size = torch.finfo(dt).bits // 8
        y = torch.empty(q.shape, dtype=dt, device=dev)
        for kind, sc in scales.items():
            one(f"quant_{lab}_{kind}",
                lambda x=x, sc=sc: quant.quantize_int8(x, sc),
                lambda x=x, sc=sc: quant.quantize_reference(x, sc),
                None, (size + 1) * n)
            one(f"dequant_{lab}_{kind}",
                lambda dt=dt, sc=sc: quant.dequantize_int8(q, sc, dt),
                lambda dt=dt, sc=sc: quant.dequantize_reference(q, sc, dt),
                (lambda sc=sc: torch.mul(q, sc)) if dt == torch.float32
                else (lambda sc=sc, y=y: torch.mul(q, sc, out=y)),
                (size + 1) * n)
    return out


# ------------------------------------------------------- the probes P1-P3


def probe_check_phase(dev) -> dict:
    """Each probe kernel against its plain version on the same seeded
    operands, two replicas, after 1 and 3 iterations (P3: 64 dots a
    call, 1 and 3 chained calls from a random seed), held to
    ``probes.compare``; bf16 P1 and P2 operands are scaled by
    ``probes.CHECK_SCALE``, so that the carry and P2's injection dot move
    the sums checked.  Returns ``{row name: (largest carry or output
    error, largest error of P1's extra)}``."""
    errs = {}
    for name, (_, _, _, taps, _) in probes.MXU_SHAPES.items():
        a, b = probes.mxu_operands(name, dev, check=True)
        e = [0.0, 0.0]
        for iters in (1, 3):
            got = probes.mxu_probe(a, b, iters, taps, replicas=2)
            want = probes.mxu_reference(a, b, iters, taps, replicas=2)
            torch.cuda.synchronize()
            for i in (0, 1):
                e[i] = max(e[i], probes.compare(got[i], want[i], iters))
        errs[f"probe_mxu_{name}"] = tuple(e)
    pa, pb = probes.pred_operands(dev, check=True)
    for name, (widths, cond) in probes.PRED_VARIANTS.items():
        w = torch.tensor(widths, dtype=torch.int32, device=dev)
        e = 0.0
        for iters in (1, 3):
            got = probes.pred_probe(w, pa, pb, iters, cond, replicas=2)
            want = probes.pred_reference(widths, pa, pb, iters, cond,
                                         replicas=2)
            torch.cuda.synchronize()
            e = max(e, probes.compare(got, want, iters))
        errs[f"probe_pred_{name}"] = (e, None)
    _, la, lb = probes.loopcost_operands(dev, replicas=2)
    gen = torch.Generator(device=dev).manual_seed(7)
    seed = torch.randn(2, probes.TILE, 512, generator=gen,
                       device=dev).to(torch.bfloat16)
    for unroll in probes.LOOPCOST_UNROLLS:
        got = want = seed
        e = 0.0
        for calls, tol_iters in ((1, 1), (2, 3)):
            for _ in range(calls):
                got = probes.loopcost_probe(got, la, lb, 64, unroll)
                want = probes.loopcost_reference(want, la, lb, 64, unroll)
            torch.cuda.synchronize()
            e = max(e, probes.compare(got, want, tol_iters))
        errs[f"probe_loopcost_u{unroll}"] = (e, None)
    return errs


def _probe_row(name, kind, err, recs, unit, **extra):
    """A probe's ``kernels`` row: ``ms``, ``plain_ms`` and the bound at
    the whole card's replicas, ``cta_ms`` at one replica; launches of
    both timing runs."""
    cta, card = recs.values()
    return {"name": name, "route": "cuda", "source": PROBE_SOURCE,
            "replaces": PROBE_REPLACES[kind],
            "launches": card["launches"] + cta["launches"],
            "max_abs_err": err[0], "ms": card["s"] * 1e3,
            "plain_ms": card["plain_s"] * 1e3,
            "bound_ms": card["bound_s"] * 1e3,
            "bound_by": card["bound_by"], "library_ms": None, "unit": unit,
            "replicas": card["replicas"], "ops_per_s": card["ops_per_s"],
            "cta_ms": cta["s"] * 1e3, "cta_ops_per_s": cta["ops_per_s"],
            **({"extra_max_abs_err": err[1]} if err[1] is not None else {}),
            **extra}


def probe_time_phase(errs: dict, gpu: str) -> list:
    """cuBLAS's chained products, then every probe timed at one replica
    and at the card's replicas (``probes.probe_rows``), each probe's
    launch count set to 0 just before and read just after.  Returns the
    ``kernels`` rows."""
    library = probes.peaks(PEAK_ITERS)
    for name, _, dt, _, variant in probes.PEAK_ROWS:
        r = library[name]
        print(f"peak {name} (cuBLAS{', ' + variant if variant else ''}): "
              f"{r['s_per_iter'] * 1e6:.1f} us per product, "
              f"{probes.shares(r['ops_per_s'], dt, variant=variant)} "
              f"[{gpu}]", flush=True)
    kernels = (probes.mxu_probe, probes.pred_probe, probes.loopcost_probe)
    for f in kernels:
        f.launches = 0
    timed = {kind: probes.probe_rows(kind, iters, library, plain)
             for kind, iters, plain in (
                 ("mxu", PROBE_ITERS, PLAIN_PROBE_ITERS),
                 ("pred", PROBE_ITERS, PLAIN_PROBE_ITERS),
                 ("loopcost", PROBE_CALLS, PLAIN_PROBE_CALLS))}
    torch.cuda.synchronize()
    counted = [f.launches for f in kernels]
    overhead = probes.loop_overhead(timed["loopcost"])
    for reps, ov in overhead.items():
        print(f"loopcost x{reps}: per-iteration overhead ~ {ov * 1e9:.1f} "
              f"ns [{gpu}]", flush=True)
    rows = []
    for name, recs in timed["mxu"].items():
        row = f"probe_mxu_{name}"
        rows.append(_probe_row(
            row, "mxu", errs[row], recs, "one iteration",
            library_peak_share=recs[max(recs)]["ops_per_s"] / probes.peak_of(
                library, probes.MXU_SHAPES[name][4])))
    for name, recs in timed["pred"].items():
        row = f"probe_pred_{name}"
        rows.append(_probe_row(row, "pred", errs[row], recs, "one iteration",
                               mean_w=recs[1]["mean_w"]))
    for unroll, recs in timed["loopcost"].items():
        cta, card = recs.values()
        row = f"probe_loopcost_u{unroll}"
        rows.append(_probe_row(
            row, "loopcost", errs[row], recs,
            f"one call of {probes.LOOPCOST_DOTS} dots",
            ns_per_dot=card["s_per_dot"] * 1e9,
            cta_ns_per_dot=cta["s_per_dot"] * 1e9,
            overhead_ns={str(k): v * 1e9 for k, v in overhead.items()}))
    for f, n, kind in zip(kernels, counted, ("mxu", "pred", "loopcost")):
        want = sum(r["launches"] for r in rows
                   if r["replaces"] == PROBE_REPLACES[kind])
        check(n == want and n > 0, f"probe {kind}: {n} launches counted, "
              f"rows hold {want}")
    return rows


# cheby_conv_kernel<T, BM, kStages, kTap>'s mangled template arguments.
_CHEBY_INSTANCE = re.compile(
    r"cheby_conv_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)EE")


def cheby_tensor_core_ops(lib) -> dict:
    """The tensor-core instructions (``HMMA``, ``HGMMA``) in the SASS of
    each instantiation of ``cheby_conv_kernel`` (K2's tap and K3's, 64-
    and 128-row tiles, 2- and 3-stage rings) in the built library, by
    ``cuobjdump -sass``; fails unless all 16 are there and every bf16 one
    has some."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    found = {}
    for block in sass.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        m = _CHEBY_INSTANCE.search(name)
        if m:
            dt = "f32" if m[1] == "f" else "bf16"
            tap = ("K2", "K3")[int(m[4])]
            found[f"cheby_conv_kernel<{dt}, {m[2]}, {m[3]}, {tap}>"] = (
                body.count("HMMA") + body.count("HGMMA"))
    bf16 = [n for k, n in found.items() if "bf16" in k]
    check(len(found) == 16 and all(n > 0 for n in bf16),
          f"cheby_conv_kernel's bf16 SASS holds no tensor-core instruction, "
          f"or an instantiation is missing: {found}")
    return found


# ------------------------------------------- the node-sharded operators, 26

# Phase 26: 4 ranks share the card over gloo (NCCL takes one rank per
# device); the chains and products at C = FIN, K = K.
HALO_RANKS = 4
HALO_ROWS = (2, 2)  # (d)'s mesh: data x nodes
HALO_FIT_STEPS = 4
HALO_EXCHANGES = 10  # exchanges timed per rank
# Phase 26 (c)'s training steps, half the driver's 200: phase 27 (c)
# runs the same driver at its defaults twice more, and the run stays
# near 8 minutes.
HALO_DRIVER_STEPS = 100


def _halo_close(got, want, what: str) -> float:
    """Phase 26's tolerances: f32 within 1e-5 of the largest value, bf16
    one bf16 ulp (``_check_close``), int8 bit-identical.  Returns the
    largest absolute difference."""
    check(got.shape == want.shape, f"{what}: shape")
    if got.numel() == 0:  # a shard of padding alone
        return 0.0
    if got.dtype == torch.float32:
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        check(err <= 1e-5 * max(top, 1e-30), f"{what}: max_abs_err {err:.3g}"
              f" over 1e-5 of the max {top:.3g}")
        return err
    return _check_close(got, want, what)


def _chain_of(op, x, k: int, quant: bool):
    """The K-term basis through ``op``'s per-hop calls, stacked."""
    first, hop = ((op.spmm_q, op.cheby_hop_q) if quant
                  else (op.matmul, op.cheby_hop))
    b = [x, first(x)]
    for _ in range(2, k):
        b.append(hop(b[-1], b[-2]))
    return torch.stack(b)


def _no_dkw(op):
    """A ragged banded operator (single-chip or sharded) without its
    deep-K-window twin: its products run K6."""
    names = {f.name for f in dataclasses.fields(op)}
    return dataclasses.replace(op, **{k: None for k in (
        "bands_dkw", "sched_dkw", "sched_dkw_int", "sched_dkw_suf")
        if k in names})


def _launched() -> dict:
    torch.cuda.synchronize()
    return {k: v for k, v in library.launch_counts().items() if v}


def sharded_one_rank_phase(L, single, chains, dev, gpu: str) -> dict:
    """Phase 26 (a): the banded halo operator at a world of one rank
    (NCCL, ``experiments.multichip.one_rank_mesh``) against phase 3's
    single-chip bf16 operator ``single`` and its int8 twin, with and
    without ``force_boundary``; then the multichip experiment's ``wrapper``
    and ``chain`` timings (``multichip.one_rank_times``: the chain's us
    per SpMM hop by hop and through ``cheby_chain``, beside the
    single-chip chain's) and the split operator's ``cheby_chain``,
    beside phase 14's ``chains``."""
    t0 = time.perf_counter()
    with multichip.one_rank_mesh(dev) as mesh:
        rec = _one_rank_checks(L, single, mesh, dev)
    rec["seconds"] = time.perf_counter() - t0
    us = rec["us_per_spmm"]
    print(f"sharded one rank (phase 26a): backend nccl, world 1; bf16 and "
          f"int8 against phase 3's single-chip operator, max_abs_err "
          f"{rec['max_abs_err']}, K1 launches a hop "
          f"{rec['regions']}; K={K} chain at C={FIN} (multichip wrapper and "
          f"chain): us per SpMM through cheby_chain "
          + ", ".join(f"{k} {v:.2f}" for k, v in us.items())
          + "; hop by hop " + ", ".join(
              f"{k} {v:.2f}" for k, v in rec["hop_us_per_spmm"].items())
          + "; single-chip hop by hop " + ", ".join(
              f"{k} {v:.2f}" for k, v in rec["plain_us_per_spmm"].items())
          + " (phase 14's single-chip cheby_finals: bf16 "
          f"{chains['dkw']['bf16']['us_per_spmm']:.2f}, int8 "
          f"{chains['dkw']['int8']['us_per_spmm']:.2f}); "
          f"{rec['seconds']:.1f} s [{gpu}]", flush=True)
    return rec


def _one_rank_checks(L, single, mesh, dev) -> dict:
    """Phase 26 (a)'s checks and timings on the one-rank ``mesh``."""
    check(mesh.backend == "nccl" and not mesh.staged,
          f"phase 26a: backend {mesh.backend}, staged {mesh.staged}")
    gen = torch.Generator(device=dev).manual_seed(26)
    xs = {"bf16": [torch.randn(single.m_padded, FIN, generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(2)],
          "int8": [torch.randint(-100, 100, (single.m_padded, FIN),
                                 generator=gen, device=dev,
                                 dtype=torch.int8) for _ in range(2)]}
    singles = {"bf16": single, "int8": quantize_banded(single, sample_x=3.0)}
    rec = {"max_abs_err": {}, "us_per_spmm": {}, "hop_us_per_spmm": {},
           "plain_us_per_spmm": {}, "regions": {}}
    with torch.no_grad():
        want = {lab: (s.spmm_q(xs[lab][0]) if lab == "int8"
                      else s.matmul(xs[lab][0]),
                      (s.cheby_hop_q if lab == "int8" else s.cheby_hop)(
                          *xs[lab]),
                      _chain_of(s, xs[lab][0], K, lab == "int8"))
                for lab, s in singles.items()}
        for fb in (0, 8):
            hb = banded_halo_laplacian(L, mesh, dtype=torch.bfloat16,
                                       rows_per_step=single.rows_per_step,
                                       force_boundary=fb)
            check(hb.bands_dkw is not None and hb.split == bool(fb)
                  and hb.m_padded == single.m_padded
                  and (hb.halo_left, hb.halo_right) == (0, 0),
                  f"phase 26a: operator (force_boundary {fb}) split "
                  f"{hb.split}, m_padded {hb.m_padded}")
            regions = len(hb.regions) - 1 if hb.split else 1
            ops = {"bf16": hb, "int8": quantize_banded_halo(hb,
                                                            sample_x=3.0)}
            check(ops["int8"].band_scale == singles["int8"].band_scale,
                  "phase 26a: int8 band scale")
            for lab, h in ops.items():
                q = lab == "int8"
                x, x0 = xs[lab]
                library.reset_launch_counts()
                y = h.spmm_q(x) if q else h.matmul(x)
                check(_launched() == {"band_dkw": regions},
                      f"phase 26a {lab}: L@x launched {_launched()}")
                library.reset_launch_counts()
                yh = (h.cheby_hop_q if q else h.cheby_hop)(x, x0)
                check(_launched() == {"band_dkw": regions},
                      f"phase 26a {lab}: the hop launched {_launched()}")
                yc = h.cheby_chain_q(x, K) if q else h.cheby_chain(x, K)
                what = f"phase 26a {lab} force_boundary {fb}"
                err = max(_halo_close(g, w, f"{what} {form}") for g, w, form
                          in zip((y, yh, yc), want[lab],
                                 ("L@x", "hop", "chain")))
                key = f"{lab}{'_split' if fb else ''}"
                rec["max_abs_err"][key] = err
                rec["regions"][key] = regions
            x = xs["bf16"][0]
            if fb:
                # The split operator's whole chain, as the multichip experiment
                # times it.
                rec["us_per_spmm"]["bf16_split"] = 1e6 * (
                    multichip.region_chain_seconds(hb, x, K))
                rec["us_per_spmm"]["int8_split"] = 1e6 * (
                    multichip.region_chain_seconds(ops["int8"], x, K))
                continue
            # The multichip experiment's wrapper and chain modes on this mesh.
            t = multichip.one_rank_times(single, hb, x, region=True, K=K)
            for lab in ("bf16", "int8"):
                rec["us_per_spmm"][lab] = 1e6 * t[f"{lab}_region"]
                rec["hop_us_per_spmm"][lab] = 1e6 * t[f"{lab}_halo"]
                rec["plain_us_per_spmm"][lab] = 1e6 * t[f"{lab}_plain"]
    return rec


def _launch_ranks(argv: list, what: str, timeout: float):
    """``argv`` on HALO_RANKS ranks through ``torch.distributed.run``;
    fails the run unless every rank exits 0.  Returns its stdout and
    seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(HALO_RANKS), *argv],
        cwd=HERE, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        # Each rank's last lines: the first rank to fail says why, the
        # others that a peer closed.
        tails = []
        for r in range(HALO_RANKS):
            lines = [s for s in proc.stderr.splitlines()
                     if s.startswith(f"[rank{r}]:")]
            tails.append("\n".join(lines[-12:]))
        check(False, f"{what}: a rank failed (exit {proc.returncode}):\n"
              f"{proc.stdout[-2000:]}\n" + "\n".join(tails))
    return proc.stdout, time.perf_counter() - t0


def sharded_ranks_phase(L, d: str, gpu: str) -> dict:
    """Phase 26 (b): ``halo_rank_kernels`` on HALO_RANKS ranks sharing
    the card; each rank checks its rows and writes its record."""
    scipy.sparse.save_npz(os.path.join(d, "L.npz"), L)
    out, sec = _launch_ranks([os.path.join(HERE, "chip_smoke.py"),
                              "--halo-rank", "kernels", "--halo-dir", d],
                             "phase 26b", 600)
    for line in out.splitlines():
        if line.startswith("distributed:"):
            print(f"  {line}")
    recs = [json.load(open(os.path.join(d, f"kernels{r}.json")))
            for r in range(HALO_RANKS)]
    for r in recs:
        print(f"  rank {r['rank']} (phase 26b): rows {r['rows']}, halo "
              f"{r['halo']} block rows, max_abs_err {r['max_abs_err']}, "
              f"kernel vs row-walk plain {r['rows_max_abs_err']}, launches "
              f"{r['launches']}, halo bytes a bf16 hop {r['bytes_per_hop']}"
              f" (want {r['bytes_want']}), exchange "
              f"{r['exchange_ms_gloo_one_card']:.3f} ms (gloo, one card)",
              flush=True)
    print(f"sharded ranks (phase 26b): {HALO_RANKS} ranks on one card over "
          f"gloo, {sec:.1f} s [{gpu}]", flush=True)
    return {"ranks": recs, "seconds": sec}


def halo_rank_kernels(d: str):
    """One rank of phase 26 (b)."""
    dev = init_distributed()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(data=1, nodes=HALO_RANKS)
    check(mesh.backend == "gloo" and mesh.staged, "phase 26b: backend")
    rank = mesh.coord("nodes")
    L = scipy.sparse.load_npz(os.path.join(d, "L.npz"))
    f32 = device_laplacian(L, fmt="banded", device=dev)
    G = f32.rows_per_step
    h32 = banded_halo_laplacian(L, mesh, rows_per_step=G)
    singles = {"f32": f32, "bf16": cast_op(f32, torch.bfloat16)}
    halos = {"f32": h32, "bf16": cast_op(h32, torch.bfloat16)}
    singles["int8"] = quantize_banded(singles["bf16"], sample_x=3.0)
    halos["int8"] = quantize_banded_halo(halos["bf16"], sample_x=3.0)
    singles["K5"] = device_laplacian(L, fmt="banded", ragged=False,
                                     dtype=torch.bfloat16, device=dev)
    halos["K5"] = banded_halo_laplacian(L, mesh, ragged=False,
                                        dtype=torch.bfloat16,
                                        rows_per_step=G)
    singles["K6"] = _no_dkw(singles["bf16"])
    halos["K6"] = _no_dkw(halos["bf16"])
    lo, hi = h32.row_range
    real = h32.real_rows
    gen = torch.Generator(device=dev).manual_seed(261)
    xg = [torch.randn(L.shape[0], FIN, generator=gen, device=dev)
          for _ in range(2)]

    def padded(x, rows):
        return torch.cat([x, x.new_zeros(rows - x.shape[0], x.shape[1])])

    rec = {"rank": rank, "rows": [lo, hi], "max_abs_err": {},
           "rows_max_abs_err": {}, "launches": {},
           "halo": [h32.halo_left, h32.halo_right]}
    kernel = {"f32": "band_dkw", "bf16": "band_dkw", "int8": "band_dkw",
              "K5": "band_uniform", "K6": "band_ragged"}
    for lab in ("f32", "bf16", "int8", "K5", "K6"):
        s, h = singles[lab], halos[lab]
        q = lab == "int8"
        dt = s.compute_dtype
        if q:
            xs = [torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
                  for x in xg]
        else:
            xs = [x.to(dt) for x in xg]
        x_s = [padded(x, s.m_padded) for x in xs]
        x_h = [padded(x, h.m_padded)[lo:hi].contiguous() for x in xs]
        what = f"phase 26b rank {rank} {lab}"
        first = "spmm_q" if q else "matmul"
        hop = "cheby_hop_q" if q else "cheby_hop"
        with torch.no_grad():
            library.reset_launch_counts()
            got = [getattr(h, first)(x_h[0]), getattr(h, hop)(*x_h)]
            if lab != "K6":
                got.append(h.cheby_chain_q(x_h[0], K) if q
                           else h.cheby_chain(x_h[0], K))
            launched = rec["launches"][lab] = _launched()
            check(set(launched) == {kernel[lab]},
                  f"{what}: launched {launched}")
            want = [getattr(s, first)(x_s[0]), getattr(s, hop)(*x_s)]
            if lab != "K6":
                want.append(_chain_of(s, x_s[0], K, q))
            forms = zip(got, want, ("L@x", "hop", "chain"))
            err = 0.0
            for got, want, form in forms:
                got = got[..., :real, :] if got.dim() == 3 else got[:real]
                want = (want[:, lo:lo + real] if want.dim() == 3
                        else want[lo:lo + real])
                err = max(err, _halo_close(got, want, f"{what} {form}"))
            rec["max_abs_err"][lab] = err
            # The kernel against the row walk's plain version on this
            # rank's halo-extended x.
            reg = h.regions["full"]
            x_ext = h._extended(x_h[0], h._exchange(x_h[0]))
            scale = h.band_scale if q else None
            rec["rows_max_abs_err"][lab] = _check_close(
                layout_call(reg, x_ext, band_scale=scale),
                rows_plain(reg, (x_ext,), scale),
                f"{what}: kernel vs plain on x [{x_ext.shape[0]}, {FIN}]")
    # The chain's adjoint in f32: the gradient of the basis' sum.
    xa = xg[0]
    u = padded(xa, h32.m_padded)[lo:hi].clone().requires_grad_()
    h32.cheby_chain(u, K).sum().backward()
    v = padded(xa, f32.m_padded).clone().requires_grad_()
    _chain_of(f32, v, K, False).sum().backward()
    want = v.grad[lo:lo + real]
    err = float((u.grad[:real] - want).abs().max()) if real else 0.0
    check(not real or err <= 1e-4 * float(want.abs().max()),
          f"phase 26b rank {rank}: the chain's adjoint err {err:.3g}")
    rec["max_abs_err"]["adjoint_f32"] = err
    # The exchange: its bytes per bf16 hop and its time.
    hb = halos["bf16"]
    xb = padded(xg[0].to(torch.bfloat16), hb.m_padded)[lo:hi].contiguous()
    sent = sum(mesh.traffic.values())
    with torch.no_grad():
        hb.matmul(xb)
    rec["bytes_per_hop"] = sum(mesh.traffic.values()) - sent
    n = HALO_RANKS
    rec["bytes_want"] = ((rank > 0) * hb.halo_right
                         + (rank < n - 1) * hb.halo_left) * 128 * FIN * 2
    check(rec["bytes_per_hop"] == rec["bytes_want"],
          f"phase 26b rank {rank}: {rec['bytes_per_hop']} halo bytes a hop")
    rec["bytes_formula"] = (hb.halo_left + hb.halo_right) * 128 * FIN * 2
    torch.cuda.synchronize()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(HALO_EXCHANGES):
        hb._exchange(xb)()
    torch.cuda.synchronize()
    rec["exchange_ms_gloo_one_card"] = ((time.perf_counter() - t0) * 1e3
                                        / HALO_EXCHANGES)
    json.dump(rec, open(os.path.join(d, f"kernels{rank}.json"), "w"))
    torch.distributed.destroy_process_group()


def sharded_driver_phase(single_acc: float, gpu: str) -> dict:
    """Phase 26 (c): the node-classification driver on HALO_RANKS ranks
    with ``--mesh-nodes 4 --halo banded --int8``, at its defaults but
    ``HALO_DRIVER_STEPS`` training steps."""
    out, sec = _launch_ranks(
        ["-m", "cnn_graph_tpu_torch.experiments.node_classification",
         "--mesh-nodes", str(HALO_RANKS), "--halo", "banded", "--int8",
         "--steps", str(HALO_DRIVER_STEPS)],
        "phase 26c", 600)
    for line in out.strip().splitlines():
        print(f"  driver: {line}")
    acc = re.search(r"train acc ([\d.]+) \| test acc ([\d.]+)", out)
    q = re.search(r"int8 test acc ([\d.]+) \(delta vs f32 ([-+][\d.]+)\)",
                  out)
    k1 = re.search(r"K1 launches per training step by rank: \[([^\]]*)\]",
                   out)
    step = re.search(r"\(([\d.]+) ms/step\)", out)
    check(acc and q and k1 and step, "phase 26c: driver lines missing")
    test_acc, delta = float(acc.group(2)), float(q.group(2))
    per_rank = [float(v) for v in k1.group(1).split(",")]
    check(abs(test_acc - single_acc) <= 0.01,
          f"phase 26c: test accuracy {test_acc}, one card {single_acc}")
    check(abs(delta) < 0.05, f"phase 26c: int8 delta {delta}")
    check(len(per_rank) == HALO_RANKS and all(v > 0 for v in per_rank),
          f"phase 26c: K1 launches per step {per_rank}")
    print(f"sharded driver (phase 26c): {HALO_RANKS} ranks, {sec:.1f} s; "
          f"test acc {test_acc} (one card {single_acc}), int8 delta "
          f"{delta:+.4f}, K1 launches per step by rank {per_rank}, "
          f"{float(step.group(1))} ms per step (gloo, one card) [{gpu}]",
          flush=True)
    return {"test_acc": test_acc, "int8_delta": delta,
            "k1_per_step": per_rank, "ms_per_step": float(step.group(1)),
            "seconds": sec}


def _fit_config(mesh=None):
    return TrainConfig(num_epochs=1, batch_size=FLOW_B, eval_frequency=
                       HALO_FIT_STEPS, learning_rate=FLOW_LR,
                       decay_steps=None, seed=FLOW_SEED, mesh=mesh)


def _fit_data(d: str):
    a = np.load(os.path.join(d, "flow.npz"))
    return [a[k] for k in ("x", "y", "vx", "vy")]


def _fit_resgnn(op, d: str, mesh=None) -> list:
    model = ResGNN(op, 12, **RESGNN,
                   generator=torch.Generator().manual_seed(FLOW_SEED))
    trainer = Trainer(model, _fit_config(mesh), task="regression")
    trainer.fit(*_fit_data(d), verbose=False)
    return [t.detach().cpu().numpy() for t in tree_leaves(trainer.params)]


def sharded_trainer_phase(flow: dict, dev, d: str, gpu: str) -> dict:
    """Phase 26 (d): ``Trainer.fit`` on a (2, 2) mesh, phase 22's ResGNN
    over the dense halo operator, against the same fit in this process
    on a single-chip operator."""
    tr, _, _, trl, val, _ = flow["splits"]
    n = HALO_FIT_STEPS * FLOW_B
    np.savez(os.path.join(d, "flow.npz"), x=tr[:n], y=trl[:n],
             vx=flow["splits"][1][:FLOW_B], vy=val[:FLOW_B])
    scipy.sparse.save_npz(os.path.join(d, "Lflow.npz"),
                          scipy.sparse.csr_matrix(flow["L"]))
    want = _fit_resgnn(device_laplacian(flow["L"], device=dev), d)
    _, sec = _launch_ranks([os.path.join(HERE, "chip_smoke.py"),
                            "--halo-rank", "trainer", "--halo-dir", d],
                           "phase 26d", 600)
    got = np.load(os.path.join(d, "trainer.npz"))
    check(len(got.files) == len(want), "phase 26d: parameter count")
    err = max(float(np.abs(got[f"p{i}"] - w).max())
              for i, w in enumerate(want))
    check(err <= 1e-4, f"phase 26d: parameters {err:.3g} from the one-"
          "process fit")
    print(f"sharded Trainer (phase 26d): ResGNN {RESGNN} on "
          f"{FLOW_NODES} regions, {HALO_FIT_STEPS} steps of {FLOW_B} on a "
          f"(data, nodes) = {HALO_ROWS} mesh over the dense halo operator: "
          f"parameters within {err:.3g} of the one-process fit; {sec:.1f} s "
          f"[{gpu}]", flush=True)
    return {"max_abs_err": err, "seconds": sec}


def halo_rank_trainer(d: str):
    """One rank of phase 26 (d)."""
    init_distributed()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(*HALO_ROWS)
    L = scipy.sparse.load_npz(os.path.join(d, "Lflow.npz"))
    params = _fit_resgnn(halo_sharded_laplacian(L, mesh), d, mesh)
    if torch.distributed.get_rank() == 0:
        np.savez(os.path.join(d, "trainer.npz"),
                 **{f"p{i}": p for i, p in enumerate(params)})
    torch.distributed.destroy_process_group()


# ------------------------------------------- the sparse halo operators, 27

# Phase 27: the sparse halo operators on HALO_RANKS ranks sharing the
# card (phase 26's runner), C = FIN, K = K.  Which kernel each format's
# products launch, by ``_launched``'s names, and its route.
SPARSE_KERNEL = {"bsr": ("bsr_csr", "K8"), "banded": ("band_uniform", "K5")}
SPARSE_SEED = 27


def _sparse_inputs(m: int, dev, seed: int):
    """Two [m, FIN] N(0, 1) inputs from a seeded generator on the card,
    the same on every process, and their int8 copies."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.randn(m, FIN, generator=gen, device=dev) for _ in range(2)]
    return xs, [torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
                for x in xs]


def _padded(x, rows):
    return torch.cat([x, x.new_zeros(rows - x.shape[0], x.shape[1])])


class _Unfused:
    """A single-chip operator whose hop is JAX's unfused ``2 (L @ x) -
    x0`` (``ChebyHopMixin``), as the BSR sparse halo operator's: in bf16
    its L@x rounds before the hop rounds again."""

    def __init__(self, op):
        self.op, self.matmul = op, op.matmul

    def cheby_hop(self, x1, x0):
        return (2.0 * self.op.matmul(x1) - x0).to(x1.dtype)


def _unfused_hop_close(got, y, x0, want, what: str) -> float:
    """A bf16 hop taken unfused against the single-chip operator's
    unfused hop from its own L@x ``y``: the two L@x differ by an ulp, so
    the hops differ within one bf16 ulp of their operands, ``2^-7 (|2y|
    + |x0|)``, plus 1e-4.  Returns the largest absolute difference."""
    err = (got.float() - want.float()).abs()
    tol = 2**-7 * (2.0 * y.float().abs() + x0.float().abs()) + 1e-4
    check(got.shape == want.shape and bool((err <= tol).all()),
          f"{what}: {int((err > tol).sum())} entries past one ulp of the "
          f"operands, max_abs_err {float(err.max()):.3g}")
    return float(err.max())


def _bf16_chain_close(got, want, ref32, what: str) -> float:
    """The bf16 K-term chain of a sparse halo operator against the
    single-chip bf16 chain: the two sum each row in other orders, so a
    one-ulp difference of an early hop feeds every later one.  Held to
    twice the single-chip chain's own distance from the f32 chain;
    returns the largest absolute difference from the single-chip
    chain."""
    err_h = float((got.float() - ref32).abs().max())
    err_s = float((want.float() - ref32).abs().max())
    check(err_h <= 2.0 * err_s + 1e-6, f"{what}: chain {err_h:.3g} from f32, "
          f"the single-chip bf16 chain {err_s:.3g}")
    return float((got.float() - want.float()).abs().max())


def scattered_refs(single, dev) -> dict:
    """Phase 27 (b)'s references, taken while phase 10's single-chip bf16
    BSR operator of the scattered graph exists: its L@x and JAX's
    unfused hop, and its int8 twin's L@x and hop, on seeded inputs, to
    the host."""
    singles = {"bf16": single, "int8": quantize_block_sparse(single,
                                                             sample_x=3.0)}
    xs, xq = _sparse_inputs(single.m, dev, SPARSE_SEED + 1)
    refs = {}
    with torch.no_grad():
        for lab, s in singles.items():
            a, b = ((xq if lab == "int8" else [x.to(torch.bfloat16)
                                               for x in xs]))
            a, b = _padded(a, s.m_padded), _padded(b, s.m_padded)
            first = s.spmm_q if lab == "int8" else s.matmul
            hop = s.cheby_hop_q if lab == "int8" else _Unfused(s).cheby_hop
            refs[lab] = (first(a).cpu(), hop(a, b).cpu(), b.cpu())
    return refs


def sparse_ranks_phase(L, L_s, refs, d: str, gpu: str) -> dict:
    """Phase 27 (a), (b) and (d): ``halo_rank_sparse`` on HALO_RANKS
    ranks sharing the card, (b) against ``scattered_refs``; every rank
    checks its rows and writes its record, then runs the dry run."""
    scipy.sparse.save_npz(os.path.join(d, "L.npz"), L)
    scipy.sparse.save_npz(os.path.join(d, "Ls.npz"), L_s)
    torch.save(refs, os.path.join(d, "refs.pt"))
    out, sec = _launch_ranks([os.path.join(HERE, "chip_smoke.py"),
                              "--halo-rank", "sparse", "--halo-dir", d],
                             "phase 27abd", 600)
    ok = [s for s in out.splitlines() if s.startswith("dryrun_multichip OK")]
    check(len(ok) == 1 and "'sparse_bsr'" in ok[0]
          and "'sparse_banded'" in ok[0], f"phase 27d: {out[-2000:]}")
    recs = [json.load(open(os.path.join(d, f"sparse{r}.json")))
            for r in range(HALO_RANKS)]
    for r in recs:
        for fmt in SPARSE_KERNEL:
            f = r[fmt]
            print(f"  rank {r['rank']} (phase 27a) {fmt}: H {f['H']}, "
                  f"ext_p {f['ext_p']}, {f['size']}, max_abs_err "
                  f"{f['max_abs_err']}, kernel vs plain "
                  f"{f['rows_max_abs_err']}, launches {f['launches']}, "
                  f"bytes a bf16 hop {f['bytes_per_hop']} (n*H*C*2 "
                  f"{f['bytes_want']}), exchange "
                  f"{f['exchange_ms_gloo_one_card']:.3f} ms (gloo, one card)",
                  flush=True)
        s = r["scattered"]
        print(f"  rank {r['rank']} (phase 27b) scattered bsr: H {s['H']}, "
              f"{s['blocks']} blocks, max_abs_err {s['max_abs_err']}, "
              f"kernel vs plain {s['rows_max_abs_err']}, launches "
              f"{s['launches']}, bytes a bf16 hop {s['bytes_per_hop']} "
              f"(n*H*C*2 {s['bytes_want']}), exchange "
              f"{s['exchange_ms_gloo_one_card']:.3f} ms (gloo, one card)",
              flush=True)
    for r in recs:
        f = r["banded64"]
        print(f"  rank {r['rank']} (phase 28c) banded {SERVE_BLOCK}x"
              f"{SERVE_BLOCK}: H {f['H']}, ext_p {f['ext_p']}, {f['size']}, "
              f"max_abs_err {f['max_abs_err']} (against the single-chip "
              f"{SERVE_BLOCK}x{SERVE_BLOCK} operator), kernel vs plain "
              f"{f['rows_max_abs_err']}, launches {f['launches']}, bytes a "
              f"bf16 hop {f['bytes_per_hop']}, exchange "
              f"{f['exchange_ms_gloo_one_card']:.3f} ms (gloo, one card)",
              flush=True)
    print(f"dryrun (phase 27d, {recs[0]['dryrun_s']:.1f} s): {ok[0]}",
          flush=True)
    print(f"sparse halo ranks (phase 27abd): {HALO_RANKS} ranks on one card "
          f"over gloo, {sec:.1f} s [{gpu}]", flush=True)
    return {"ranks": recs, "seconds": sec}


def _sparse_rank_format(fmt, L, mesh, singles, xg, rank,
                        block_shape=(128, 128), phase="27a"):
    """Phase 27 (a) on one rank for one format: L@x, the hop and the
    K-term chain in f32, bf16 and int8 against the single-chip banded
    operator's rows, the kernel against its plain version on this rank's
    extended x, the f32 adjoint, the exchange's bytes and time.  Phase 28
    (c) runs the banded format at another ``block_shape`` against the
    single-chip operator at that shape."""
    h32 = sparse_halo_laplacian(L, mesh, fmt=fmt, block_shape=block_shape)
    hb = sparse_halo_laplacian(L, mesh, fmt=fmt, dtype=torch.bfloat16,
                               block_shape=block_shape)
    halos = {"f32": h32, "bf16": hb,
             "int8": quantize_sparse_halo(hb, sample_x=3.0)}
    check(all(getattr(h.local, "block_shape", None) == tuple(block_shape)
              for h in halos.values()),
          f"phase {phase} rank {rank} {fmt}: block shape")
    check(halos["int8"].band_scale == singles["int8"].band_scale,
          f"phase {phase} rank {rank} {fmt}: int8 band scale")
    name, route = SPARSE_KERNEL[fmt]
    lo, hi = h32.row_range
    real = h32.real_rows
    rec = {"H": h32.halo, "ext_p": h32.ext_cols_padded,
           "size": (f"{h32.local.blocks.shape[0]} blocks" if fmt == "bsr"
                    else f"band {tuple(h32.local.band.shape[:2])}"),
           "max_abs_err": {}, "rows_max_abs_err": {}, "launches": {}}
    chains = {}
    for lab in ("f32", "bf16", "int8"):
        s, h = singles[lab], halos[lab]
        q = lab == "int8"
        xs = ([torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
               for x in xg] if q else [x.to(s.compute_dtype) for x in xg])
        x_s = [_padded(x, s.m_padded) for x in xs]
        x_h = [_padded(x, h.m_padded)[lo:hi].contiguous() for x in xs]
        what = f"phase {phase} rank {rank} {fmt} {lab}"
        # The BSR format's float hop is JAX's unfused one: so is the
        # reference's.
        ref = _Unfused(s) if fmt == "bsr" and not q else s
        with torch.no_grad():
            library.reset_launch_counts()
            got = [(h.spmm_q if q else h.matmul)(x_h[0]),
                   (h.cheby_hop_q if q else h.cheby_hop)(*x_h),
                   _chain_of(h, x_h[0], K, q)]
            launched = rec["launches"][lab] = _launched()
            check(set(launched) == {name} and library.launch_counts()[name]
                  == K + 1, f"{what}: launched {launched}")
            want = [(ref.spmm_q if q else ref.matmul)(x_s[0]),
                    (ref.cheby_hop_q if q else ref.cheby_hop)(*x_s),
                    _chain_of(ref, x_s[0], K, q)]
            chains[lab] = want[2]
            err = 0.0
            for g, w, form in zip(got, want, ("L@x", "hop", "chain")):
                g = g[..., :real, :] if g.dim() == 3 else g[:real]
                w = w[:, lo:lo + real] if w.dim() == 3 else w[lo:lo + real]
                if lab == "bf16" and form == "chain":
                    ref32 = chains["f32"][:, lo:lo + real]
                    err = max(err, _bf16_chain_close(g, w, ref32,
                                                     f"{what} {form}"))
                elif lab == "bf16" and form == "hop" and fmt == "bsr":
                    err = max(err, _unfused_hop_close(
                        g, want[0][lo:lo + real], x_s[1][lo:lo + real], w,
                        f"{what} {form}"))
                else:
                    err = max(err, _halo_close(g, w, f"{what} {form}"))
            rec["max_abs_err"][lab] = err
            # The kernel against its plain version on this rank's
            # extended x (launches for the check, not counted above).
            x_ext = h._extended(x_h[0])
            scale = h.band_scale if q else None
            if fmt == "bsr":
                k = h.local.kernel_call(x_ext, None, route, scale)
                p = bsr_rows_reference(h.local.blocks, h.local.nz_rowptr,
                                       h.local.nz_cols, h.local.nz_pos,
                                       x_ext, block_scale=scale)
            else:
                xp = x_ext.index_select(0, h.colperm)
                k = layout_call(h.local, xp, band_scale=scale)
                p = rows_plain(h.local, (xp,), scale)
            rec["rows_max_abs_err"][lab] = _check_close(
                k, p, f"{what}: kernel vs plain on x [{x_ext.shape[0]}, "
                f"{FIN}]")
    # The adjoint in f32: the gradient of sum(y^2).
    u = _padded(xg[0], h32.m_padded)[lo:hi].clone().requires_grad_()
    (h32.matmul(u) ** 2).sum().backward()
    v = _padded(xg[0], singles["f32"].m_padded).clone().requires_grad_()
    (singles["f32"].matmul(v) ** 2).sum().backward()
    want = v.grad[lo:lo + real]
    err = float((u.grad[:real] - want).abs().max()) if real else 0.0
    check(not real or err <= 1e-4 * float(want.abs().max()),
          f"phase {phase} rank {rank} {fmt}: the adjoint err {err:.3g}")
    rec["max_abs_err"]["adjoint_f32"] = err
    rec.update(_exchange_record(hb, mesh, _padded(
        xg[0].to(torch.bfloat16), hb.m_padded)[lo:hi].contiguous()))
    return rec


def _exchange_record(h, mesh, x) -> dict:
    """Bytes this rank sends in one product's exchange against ``n * H *
    C * itemsize``, and the exchange's ms (gloo, one card)."""
    sent = sum(mesh.traffic.values())
    with torch.no_grad():
        h.matmul(x)
    got = sum(mesh.traffic.values()) - sent
    want = HALO_RANKS * h.halo * x.shape[1] * x.element_size()
    check(got == want, f"phase 27: {got} halo bytes a hop, want {want}")
    torch.cuda.synchronize()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(HALO_EXCHANGES):
        h._extended(x)
    torch.cuda.synchronize()
    return {"bytes_per_hop": got, "bytes_want": want,
            "exchange_ms_gloo_one_card": ((time.perf_counter() - t0) * 1e3
                                          / HALO_EXCHANGES)}


def halo_rank_sparse(d: str):
    """One rank of phase 27 (a), (b) and (d)."""
    dev = init_distributed()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(data=1, nodes=HALO_RANKS)
    check(mesh.backend == "gloo" and mesh.staged, "phase 27: backend")
    rank = mesh.coord("nodes")
    L = scipy.sparse.load_npz(os.path.join(d, "L.npz"))
    f32 = device_laplacian(L, fmt="banded", device=dev)
    singles = {"f32": f32, "bf16": cast_op(f32, torch.bfloat16)}
    singles["int8"] = quantize_banded(singles["bf16"], sample_x=3.0)
    xg, _ = _sparse_inputs(L.shape[0], dev, SPARSE_SEED)
    rec = {"rank": rank}
    for fmt in SPARSE_KERNEL:
        rec[fmt] = _sparse_rank_format(fmt, L, mesh, singles, xg, rank)
    del singles, f32
    torch.cuda.empty_cache()

    # Phase 28 (c): the banded shard at SERVE_BLOCK x SERVE_BLOCK blocks
    # against the single-chip operator at that shape.
    f32 = device_laplacian(L, fmt="banded", block_size=SERVE_BLOCK,
                           device=dev)
    singles = {"f32": f32, "bf16": cast_op(f32, torch.bfloat16)}
    singles["int8"] = quantize_banded(singles["bf16"], sample_x=3.0)
    rec["banded64"] = _sparse_rank_format(
        "banded", L, mesh, singles, xg, rank,
        block_shape=(SERVE_BLOCK, SERVE_BLOCK), phase="28c")
    del singles, f32
    torch.cuda.empty_cache()

    # (b): the scattered graph in bsr, bf16 and int8, L@x and the hop.
    L_s = scipy.sparse.load_npz(os.path.join(d, "Ls.npz"))
    refs = torch.load(os.path.join(d, "refs.pt"))
    hb = sparse_halo_laplacian(L_s, mesh, dtype=torch.bfloat16)
    halos = {"bf16": hb, "int8": quantize_sparse_halo(hb, sample_x=3.0)}
    xs, xq = _sparse_inputs(L_s.shape[0], dev, SPARSE_SEED + 1)
    lo, hi = hb.row_range
    real = hb.real_rows
    s = rec["scattered"] = {"H": hb.halo, "blocks": hb.local.blocks.shape[0],
                            "max_abs_err": {}, "rows_max_abs_err": {},
                            "launches": {}}
    for lab, h in halos.items():
        q = lab == "int8"
        a, b = (_padded(v, h.m_padded)[lo:hi].contiguous() for v in (
            xq if q else [x.to(torch.bfloat16) for x in xs]))
        what = f"phase 27b rank {rank} scattered {lab}"
        with torch.no_grad():
            library.reset_launch_counts()
            got = [(h.spmm_q if q else h.matmul)(a),
                   (h.cheby_hop_q if q else h.cheby_hop)(a, b)]
            launched = s["launches"][lab] = _launched()
            check(launched == {"bsr_csr": 2}, f"{what}: launched {launched}")
            y_s, hop_s, x0_s = (t[lo:lo + real].to(dev) for t in refs[lab])
            s["max_abs_err"][lab] = max(
                _halo_close(got[0][:real], y_s, f"{what} L@x"),
                _halo_close(got[1][:real], hop_s, f"{what} hop") if q
                else _unfused_hop_close(got[1][:real], y_s, x0_s, hop_s,
                                        f"{what} hop"))
            x_ext = h._extended(a)
            scale = h.band_scale if q else None
            s["rows_max_abs_err"][lab] = _check_close(
                h.local.kernel_call(x_ext, None, "K8", scale),
                bsr_rows_reference(h.local.blocks, h.local.nz_rowptr,
                                   h.local.nz_cols, h.local.nz_pos, x_ext,
                                   block_scale=scale),
                f"{what}: kernel vs plain on x [{x_ext.shape[0]}, {FIN}]")
    s.update(_exchange_record(hb, mesh, _padded(
        xs[0].to(torch.bfloat16), hb.m_padded)[lo:hi].contiguous()))
    del halos, hb
    torch.cuda.empty_cache()

    # (d): the dry run's three parts on this world; rank 0 prints.
    t0 = time.perf_counter()
    dryrun_multichip()
    rec["dryrun_s"] = time.perf_counter() - t0
    json.dump(rec, open(os.path.join(d, f"sparse{rank}.json"), "w"))
    torch.distributed.destroy_process_group()


def sparse_driver_phase(single_acc: float, gpu: str) -> dict:
    """Phase 27 (c): the node-classification driver on HALO_RANKS ranks
    at its defaults with ``--mesh-nodes 4 --int8``, ``--halo sparse``
    then ``--halo sparse-banded``: test accuracy within 0.01 of phase 25
    (c)'s one card, int8 within 0.05 of the float accuracy, the format's
    kernel launched every step on every rank."""
    out = {}
    for halo, (_, route) in (("sparse", SPARSE_KERNEL["bsr"]),
                             ("sparse-banded", SPARSE_KERNEL["banded"])):
        text, sec = _launch_ranks(
            ["-m", "cnn_graph_tpu_torch.experiments.node_classification",
             "--mesh-nodes", str(HALO_RANKS), "--halo", halo, "--int8"],
            f"phase 27c {halo}", 600)
        for line in text.strip().splitlines():
            print(f"  driver {halo}: {line}")
        acc = re.search(r"train acc ([\d.]+) \| test acc ([\d.]+)", text)
        q = re.search(r"int8 test acc ([\d.]+) \(delta vs f32 "
                      r"([-+][\d.]+)\)", text)
        k = re.search(rf"{route} launches per training step by rank: "
                      r"\[([^\]]*)\]", text)
        step = re.search(r"\(([\d.]+) ms/step\)", text)
        check(acc and q and k and step, f"phase 27c {halo}: lines missing")
        test_acc, delta = float(acc.group(2)), float(q.group(2))
        per_rank = [float(v) for v in k.group(1).split(",")]
        check(abs(test_acc - single_acc) <= 0.01,
              f"phase 27c {halo}: test accuracy {test_acc}, one card "
              f"{single_acc}")
        check(abs(delta) < 0.05, f"phase 27c {halo}: int8 delta {delta}")
        check(len(per_rank) == HALO_RANKS and all(v > 0 for v in per_rank),
              f"phase 27c {halo}: {route} launches per step {per_rank}")
        out[halo] = {"test_acc": test_acc, "int8_delta": delta,
                     "launches_per_step": per_rank,
                     "ms_per_step": float(step.group(1)), "seconds": sec}
        print(f"sparse halo driver (phase 27c) --halo {halo}: "
              f"{HALO_RANKS} ranks, {sec:.1f} s; test acc {test_acc} (one "
              f"card {single_acc}), int8 delta {delta:+.4f}, {route} launches"
              f" per step by rank {per_rank}, {float(step.group(1))} ms per "
              f"step (gloo, one card) [{gpu}]", flush=True)
    return out


def bcoo_phase(L, reqs, dev, gpu: str) -> dict:
    """Phase 27 (e): one NodeClassifier request on a ``fmt="bcoo"``
    operator on the card (``torch.sparse.mm``, a library call: JAX's BCOO
    has no Pallas kernel) against the f32 banded operator's logits on the
    same weights, within 1e-4 of their max."""
    t0 = time.perf_counter()
    bcoo = device_laplacian(L, fmt="bcoo", device=dev)
    band = device_laplacian(L, fmt="banded", device=dev)
    check(bcoo.mat.is_cuda and bcoo.m_padded <= band.m_padded,
          "phase 27e: the BCOO operator")
    model = NodeClassifier(band, FIN, CLASSES, hidden=[], K=K,
                           generator=torch.Generator().manual_seed(0))
    params = model.param_tree()
    twin = map_operators(model, lambda _: bcoo)
    x = reqs[0][:bcoo.m_padded].float()
    with torch.no_grad():
        library.reset_launch_counts()
        got = twin.apply(params, x)
        check(not _launched(), "phase 27e: BCOO launched a kernel")
        want = model.apply(params, _padded(x, band.m_padded))[:bcoo.m_padded]
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    check(err <= 1e-4 * top, f"phase 27e: BCOO logits {err:.3g} from the "
          f"banded operator's (max {top:.3g})")
    ms = cuda_ms(lambda: twin.apply(params, x), 3)
    print(f"BCOO (phase 27e): {bcoo.nnz} nonzeros, one request's logits "
          f"within {err:.3g} of the f32 banded operator's (max {top:.3g}); "
          f"{ms:.3f} ms per request (torch.sparse.mm, f32); "
          f"{time.perf_counter() - t0:.1f} s [{gpu}]", flush=True)
    return {"max_abs_err": err, "ms": ms}


HALO_RANK_TASKS = {"kernels": halo_rank_kernels,
                   "trainer": halo_rank_trainer,
                   "sparse": halo_rank_sparse}


# -------------------------------------- other block shapes, Graclus, 28

# Phase 28: the banded operators at block shapes other than 128x128 (JAX
# builds any), (a) on the 50k city graph and on city_graph(SIDE_SMALL)
# (1,600 nodes), its 128x128 operator timed beside them; (b) the 50k
# NodeClassifier served and trained at SERVE_BLOCK; (c) in phase 27's
# world; (d) Graclus with the native matcher and the Python loop.
SHAPES_50K = ((64, 64), (32, 32))
SIDE_SMALL = 40
# (24, 40): block edges that are not powers of two, which the kernel
# divides by where it shifts by the others.
SHAPES_SMALL = ((8, 8), (16, 16), (32, 64), (64, 32), (24, 40), (128, 128))
SERVE_BLOCK = 64
GRACLUS_LEVELS = 4


def _shape_tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def shape_layout_ops(L, shape, dev, sample: float) -> dict:
    """The three layouts' operators of ``L`` at block ``shape`` in int8,
    bf16 and f32, built as phase 13 builds them at 128x128: K1 on the
    dkw layout, K5 on the uniform band, K6 on a ragged band built
    without the dkw twin (quantized first) and then given
    ``use_pallas``."""
    def build(**kw):
        return device_laplacian(L, fmt="banded", block_size=shape,
                                dtype=torch.bfloat16, device=dev, **kw)

    dkw, uni, rag = build(), build(ragged=False), build(use_pallas=False)
    out = {"dkw": {"int8": quantize_banded(dkw, sample_x=sample),
                   "bf16": dkw, "f32": cast_op(dkw)},
           "uniform": {"int8": quantize_banded(uni, sample_x=sample),
                       "bf16": uni, "f32": cast_op(uni)},
           "ragged": {lab: dataclasses.replace(o, use_pallas=True)
                      for lab, o in (
                          ("int8", quantize_banded(rag, sample_x=sample)),
                          ("bf16", rag), ("f32", cast_op(rag)))}}
    for lay, by in out.items():
        for lab, o in by.items():
            check(layout_of(o) == lay and o.block_shape == tuple(shape),
                  f"phase 28a {_shape_tag(shape)} {lay} {lab}: layout "
                  f"{layout_of(o)}, block {o.block_shape}")
    return out


def shape_kernel_phase(L, shapes, graph: str, gen, lib, ref, dev,
                       gpu: str) -> dict:
    """Phase 28 (a) on one graph: at each block shape, K1, K5 and K6 in
    int8, bf16 and f32 against both plain versions in every form (phase
    3's ``band_kernel_check``: L@x, the hop, +c) and in place
    (``inplace_phase``), timed; each printed beside the 128x128 kernel's
    time on the same graph, ``ref[(layout, dtype)]``, and the sparse
    bound.  ``lib``: the library times by dtype (None: timed here on
    each shape's padding).  Records by ``(shape, layout, dtype)``."""
    recs = {}
    for shape in shapes:
        t0 = time.perf_counter()
        ops = shape_layout_ops(L, shape, dev, 3.0)
        bf = ops["dkw"]["bf16"]
        lib_s = lib if lib is not None else library_phase(
            csr_operand(L, bf.m_padded, dev), gen,
            f"{graph} {_shape_tag(shape)}", gpu)
        n_blocks = sum(b.shape[0] * b.shape[2] // shape[1]
                       for b in bf.bands_dkw)
        uni = ops["uniform"]["bf16"]
        print(f"phase 28a {graph} {_shape_tag(shape)}: W {uni.band_width}, "
              f"levels {bf.levels}, {n_blocks} dkw blocks, "
              f"{bf.band.shape[0]} ragged, "
              f"{uni.band.shape[0] * uni.band_width} uniform; set-up "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del uni
        for lay, by in ops.items():
            for lab, o in by.items():
                what = f"{KERNEL_ID[lay]} {lab} {graph} {_shape_tag(shape)}"
                rec = {**band_kernel_check(o, gen, what, lib_s),
                       **inplace_phase(o, gen, what), "graph": graph,
                       "ms_128": ref.get((lay, lab))}
                recs[(shape, lay, lab)] = rec
                base = ref.get((lay, lab))
                beside = ("" if base is None else
                          f" (128x128 on this graph: {base:.4f} ms)")
                print_band_kernel(
                    f"band_{lay} ({KERNEL_ID[lay]}) {lab} {graph} "
                    f"{_shape_tag(shape)}{beside}", rec, gpu)
        del ops
        torch.cuda.empty_cache()
        print(f"phase 28a {graph} {_shape_tag(shape)}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return recs


def shape_model_phase(L, nc_data, reqs, k1_logits, tmp: str,
                      gpu: str) -> dict:
    """Phase 28 (b): phases 3-5's NodeClassifier (K=K, Fin=FIN, CLASSES
    classes, the same seed) on the 50k operator at SERVE_BLOCK x
    SERVE_BLOCK blocks: N_REQUESTS requests each in bf16 and int8 through
    K1 (K-1 launches a request), the int8 logits equal to the plain
    twin's; the served logits against phase 4's 128x128 ones
    (``k1_logits``: the kernel's sums do not depend on the block, so
    they are expected equal); one request each through K5 and K6; one
    deep bf16 training step (3 (K-1) launches) against the plain
    version; the int8 artifact exported and loaded in this process."""
    t0 = time.perf_counter()
    dev = reqs[0].device
    shape = (SERVE_BLOCK, SERVE_BLOCK)

    def build(**kw):
        return device_laplacian(L, fmt="banded", block_size=SERVE_BLOCK,
                                dtype=torch.bfloat16, device=dev, **kw)

    op = build()
    check(layout_of(op) == "dkw" and op.block_shape == shape,
          f"phase 28b: layout {layout_of(op)}, block {op.block_shape}")
    setup = time.perf_counter() - t0
    model = NodeClassifier(op, FIN, CLASSES, hidden=[], K=K,
                           generator=torch.Generator().manual_seed(0))
    params = model.param_tree()
    served = {"bf16": compile_serving(model, params, reqs[0], int8=False),
              "int8": compile_serving(model, params, reqs[0], int8=True)}
    n = N_REQUESTS
    by_mode = {"bf16": reqs[:n], "int8": reqs[n:]}
    sv = banded_serve_phase(served, by_mode, banded_dkw,
                            f"serve {_shape_tag(shape)}", gpu)
    rec = {"launches": dict(sv["launches"]), "same_as_128": {},
           "diff_from_128": {}}
    twin = compile_serving(map_operators(served["int8"].model, _plain_twin),
                           params, reqs[0], int8=False)
    for y, x in zip(sv["logits"]["int8"], by_mode["int8"]):
        check(torch.equal(y, twin(x)), "phase 28b int8: served logits not "
              "bit-identical to the plain twin's")
    for mode in ("bf16", "int8"):
        diffs = [float((a - b).abs().max()) for a, b in
                 zip(sv["logits"][mode], k1_logits[mode])]
        rec["diff_from_128"][mode] = max(diffs)
        rec["same_as_128"][mode] = all(torch.equal(a, b) for a, b in
                                       zip(sv["logits"][mode],
                                           k1_logits[mode]))
    rec["request_ms"] = {mode: cuda_ms(lambda s=srv: s(reqs[0]), 5)
                         for mode, srv in served.items()}

    # One request each through K5 and K6 at the same block.
    uni, rag = build(ragged=False), build(use_pallas=False)
    lay_ops = {"uniform": {"bf16": uni,
                           "int8": quantize_banded(uni, sample_x=float(
                               max(x.abs().max() for x in reqs)))},
               "ragged": {lab: dataclasses.replace(o, use_pallas=True)
                          for lab, o in (("bf16", rag), (
                              "int8", quantize_banded(rag, sample_x=float(
                                  max(x.abs().max() for x in reqs)))))}}
    for lay, by in lay_ops.items():
        srv = {mode: compile_serving(map_operators(model, lambda _, o=o: o),
                                     params, reqs[0], int8=False)
               for mode, o in by.items()}
        r = banded_serve_phase(srv, {"bf16": reqs[:1],
                                     "int8": reqs[n:n + 1]},
                               LAYOUT_KERNELS[lay],
                               f"{lay} serve {_shape_tag(shape)}", gpu)
        rec[f"{lay}_launches"] = dict(r["launches"])
        rec[f"{lay}_request_ms"] = {
            mode: cuda_ms(lambda s=s: s(reqs[0]), 5)
            for mode, s in srv.items()}
        for mode, ys in r["logits"].items():
            rec["diff_from_128"][f"{lay}_{mode}"] = float(
                (ys[0] - k1_logits[mode][0]).abs().max())
    del lay_ops, uni, rag

    # One deep bf16 training step on K1.
    deep = NodeClassifier(op, FIN, CLASSES, hidden=[FIN], K=K, dropout=1.0,
                          generator=torch.Generator().manual_seed(0))
    dparams = _on(deep.param_tree(), dev)

    def step(m=deep):
        return train_node_classifier(
            m, dparams, *nc_data, steps=1, learning_rate=LEARNING_RATE,
            generator=torch.Generator(device=dev).manual_seed(0))

    reset_band_launches()
    _, losses = step()
    torch.cuda.synchronize()
    forms = dict(banded_dkw.form_launches)
    rec["train_launches"] = banded_dkw.launches
    check(rec["train_launches"] == 3 * (K - 1) and forms == STEP_FORMS
          and sum(band_launches().values()) == rec["train_launches"],
          f"phase 28b train: launches {band_launches()} {forms}")
    check(bool(torch.isfinite(losses).all()), "phase 28b train: loss")
    dtwin = copy.copy(deep)
    dtwin.op = _plain_twin(op)
    rec["train_loss_rel_err"], rec["train_grad_rel_err"] = check_step(
        deep, dtwin, dparams, nc_data, 2e-2, "phase 28b train",
        lambda: banded_dkw.launches)
    rec["train_ms"] = cuda_ms(step, 2)

    # The int8 artifact, exported and loaded in this process.
    rec["artifact"] = artifact_phase(
        model, params, reqs[0], by_mode["int8"], served["int8"], "band_dkw",
        K - 1, True, f"int8 {_shape_tag(shape)}", tmp, gpu)
    rec["seconds"] = time.perf_counter() - t0
    print(f"phase 28b {_shape_tag(shape)}: operator set-up {setup:.1f} s; "
          f"requests {rec['request_ms']} ms, K1 launches "
          f"{rec['launches']}, served logits equal to phase 4's 128x128 "
          f"{rec['same_as_128']} (max diff {rec['diff_from_128']}); K5 "
          f"{rec['uniform_launches']} {rec['uniform_request_ms']} ms, K6 "
          f"{rec['ragged_launches']} {rec['ragged_request_ms']} ms; one "
          f"deep bf16 step: {rec['train_launches']} K1 launches "
          f"{forms}, loss rel err {rec['train_loss_rel_err']:.3g}, "
          f"gradient err {rec['train_grad_rel_err']:.3g} of max, "
          f"{rec['train_ms']:.3f} ms; artifact "
          f"{rec['artifact']['launches']} launches, bit-identical; "
          f"{rec['seconds']:.1f} s [{gpu}]", flush=True)
    return rec


@contextlib.contextmanager
def _python_matcher():
    """``graphs.coarsen`` with the Python loop as its matcher."""
    fn = native.graclus_one_level
    native.graclus_one_level = coarsening.graclus_pairing
    try:
        yield
    finally:
        native.graclus_one_level = fn


def graclus_phase(positions_50k, gpu: str) -> dict:
    """Phase 28 (d): Graclus over GRACLUS_LEVELS levels with the native
    matcher and with the Python loop, on the MNIST grid graph (8-NN) and
    the 50k city graph's 8-NN adjacency: equal clusters and coarse
    graphs; the seconds of each (host)."""
    rec = {}
    # The grid's kNN as mnist_graph_data builds it (dense); the 50k
    # graph's through the k-d tree (the dense route would take minutes).
    for name, z, algorithm in (("mnist", graphs.grid(28), "dense"),
                               ("city50k", positions_50k, "kd_tree")):
        A = graphs.adjacency(*graphs.knn(np.asarray(z, np.float64), k=KNN,
                                         algorithm=algorithm))
        t0 = time.perf_counter()
        gn, pn = graphs.graclus(A, GRACLUS_LEVELS, seed=0)
        t_native = time.perf_counter() - t0
        with _python_matcher():
            t0 = time.perf_counter()
            gp, pp = graphs.graclus(A, GRACLUS_LEVELS, seed=0)
            t_loop = time.perf_counter() - t0
        check(all(np.array_equal(a, b) for a, b in zip(pn, pp))
              and all((a != b).nnz == 0 for a, b in zip(gn, gp)),
              f"phase 28d {name}: the matchers' clusters differ")
        rec[name] = {"nodes": A.shape[0], "native_s": t_native,
                     "python_s": t_loop,
                     "levels": [g.shape[0] for g in gn]}
        print(f"graclus (phase 28d) {name}: {A.shape[0]} nodes, levels "
              f"{rec[name]['levels']}, equal clusters; native "
              f"{t_native:.3f} s, Python loop {t_loop:.3f} s (host) [{gpu}]",
              flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-dir", help="also trace requests and training "
                    "steps with torch.profiler and write the tables here")
    # One rank of phase 26's worlds, which this script launches itself.
    ap.add_argument("--halo-rank", choices=sorted(HALO_RANK_TASKS),
                    help=argparse.SUPPRESS)
    ap.add_argument("--halo-dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is visible")
    if args.halo_rank:
        HALO_RANK_TASKS[args.halo_rank](args.halo_dir)
        return 0
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card()
    print(f"card: {gpu}", flush=True)

    # Phase 2: one nvcc per source and g++ for the host matcher, all
    # started together.
    t0 = time.perf_counter()
    sources = ("band", "cheby_fused", "bsr", "probes", "quant")
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        host = pool.submit(_build.build_host, "graph_kernels")
        logs = dict(zip(sources, pool.map(_build.build, sources)))
        host.result()
    print(f"build: {', '.join(f'{n}.cu' for n in sources)} and "
          f"native/graph_kernels.cpp in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, (_, log) in logs.items():
        for line in log.splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                print(f"  ptxas {name}: {line.strip()}")
    for kernel, n in cheby_tensor_core_ops(logs["cheby_fused"][0]).items():
        print(f"  sass cheby_fused: {kernel}: {n} HMMA/HGMMA")

    t0 = time.perf_counter()
    L, positions = graphs.city_graph(SIDE, k=KNN, seed=0)
    # The row index the banded kernels walk, timed where the operator
    # builds it.
    with call_seconds(packing, "band_row_index") as index_s:
        op = device_laplacian(L, fmt="auto", dtype=torch.bfloat16,
                              device=dev)
    check(len(index_s) == 1, f"{len(index_s)} row index builds")
    check(isinstance(op, BandedLaplacian), f"auto format gave {type(op)}")
    # One feature matrix per request, and the last one for training.
    labels, feats = request_features(positions, 2 * N_REQUESTS + 1)
    sample = float(max(f.abs().max() for f in feats[:2 * N_REQUESTS]))
    ops = {"bf16": op, "int8": quantize_banded(op, sample_x=sample),
           "f32": cast_op(op)}
    n_blocks = sum(b.shape[0] * b.shape[2] // 128 for b in op.bands_dkw)
    setup = time.perf_counter() - t0
    print(f"graph: {op.m} nodes, nnz {op.nnz}, levels {op.levels}, "
          f"G {op.rows_per_step}, {n_blocks} band blocks, set-up "
          f"{setup:.1f} s (the row index {index_s[0]:.3f} s)", flush=True)

    # Phase 16 first for the city graph: the library call, printed beside
    # the banded kernels of phases 3 and 13.
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = {"city": library_phase(csr_operand(L, op.m_padded, dev), gen,
                                 "50k city", gpu)}

    # Phase 3: K1 against both plain versions at the serving shape.
    checks = {lab: band_kernel_check(ops[lab], gen, f"K1 {lab}", lib["city"])
              for lab in ("int8", "bf16", "f32")}
    for lab, rec in checks.items():
        print_band_kernel(f"band_dkw (K1) {lab}", rec, gpu)

    # Phase 4: the main path, through the user's entry points.
    model = NodeClassifier(op, FIN, CLASSES, hidden=[], K=K,
                           generator=torch.Generator().manual_seed(0))
    params = model.param_tree()
    reqs = [f.to(dev) for f in feats[:2 * N_REQUESTS]]
    served = {
        "bf16": compile_serving(model, params, reqs[0], int8=False),
        "int8": compile_serving(model, params, reqs[0], int8=True),
    }
    served_k1 = banded_serve_phase(
        served, {"bf16": reqs[:N_REQUESTS], "int8": reqs[N_REQUESTS:]},
        banded_dkw, "serve", gpu)
    launches, logits = served_k1["launches"], served_k1["logits"]
    agree = float((logits["int8"][0].argmax(1) == served["bf16"](
        reqs[N_REQUESTS]).argmax(1)).float().mean())
    print(f"int8 vs bf16 predicted class agreement, one request: "
          f"{agree:.4f}")

    # Phase 5: training, the deep model on the same graph.
    nc_data = (feats[-1].to(dev), labels.to(dev),
               torch.ones(op.m, dtype=torch.bool, device=dev))
    trains = {"bf16": train_phase(ops["bf16"], 1.0, nc_data, "bf16"),
              "f32": train_phase(ops["f32"], 0.8, nc_data, "f32")}
    for mode, rec in trains.items():
        print(f"train {mode}: {TRAIN_STEPS} adam steps, {rec['launches']} "
              f"kernel launches {rec['forms']}, losses "
              f"{[round(v, 4) for v in rec['losses']]}; one step vs plain: "
              f"loss rel err {rec['loss_rel_err']:.3g}, gradient err "
              f"{rec['grad_rel_err']:.3g} of max; {rec['ms']:.3f} ms per "
              f"step (plain {rec['plain_ms']:.3f} ms), peak memory "
              f"{rec['peak_gb']:.2f} GiB [{gpu}]", flush=True)

    # Phase 6: latency.
    lat = {mode: cuda_ms(lambda s=s: s(reqs[0]), 5)
           for mode, s in served.items()}
    for mode, ms in lat.items():
        print(f"request latency {mode}: {ms:.3f} ms "
              f"({K - 1} SpMMs, {op.m} nodes, Fin {FIN}) [{gpu}]")

    # Phase 29: the int8 conversions at the 50k request's carries.
    conv_rec = conversion_phase(dev, gpu)
    conv_launches = served_k1["conversions"]["int8"]

    # Phase 25 (a): the int8 request as a serving artifact, loaded and
    # served in a fresh process.
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    art_k1 = artifact_subprocess_phase(model, params, reqs[N_REQUESTS:],
                                       logits["int8"], served["int8"],
                                       tmp.name, gpu)
    art_s = time.perf_counter() - t0

    # Phase 7: K2 and K3 against their plain versions, and timed.
    t0 = time.perf_counter()
    splits = synthetic_mnist(n_train=CHEB_B, n_val=0,
                             n_test=N_REQUESTS * CHEB_B, seed=CHEB_SEED)
    data, Ls, perm = mnist_graph_data(splits, seed=CHEB_SEED)
    print(f"mnist graph: levels {[L.shape[0] for L in Ls]} nodes, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kchecks = cheby_kernel_phase(Ls, dev, gen)

    def kernel_line(r):
        geo = r["geometry"]
        return (f"max_abs_err {r['max_abs_err']:.3g} (of max "
                f"{r['scale']:.3g}), {r['ms']:.4f} ms (plain "
                f"{r['plain_ms']:.4f} ms; bound "
                f"{r['bound']['bound_us'] / 1e3:.4f} ms "
                f"{r['bound']['bound_by']}); {geo['groups']} clusters of "
                f"{geo['cluster']} CTAs, {geo['rows']}-row tiles, "
                f"{geo['smem']} B shared memory, "
                f"{geo['resident_clusters']} clusters at once")

    for lab in DTYPES:
        for shape, (B, lvl, F, O) in K2_SHAPES.items():
            m = Ls[lvl].shape[0]
            print(f"kernel K2 {lab} {shape} x [{B}, {m}, {F}] "
                  f"w [{CHEB['K'][0]}, {F}, {O}]: "
                  f"{kernel_line(kchecks[f'{lab}_{shape}'])} [{gpu}]",
                  flush=True)
            if shape in K3_SHAPES:
                r = kchecks[f"{lab}_{shape}_K3"]
                print(f"kernel K3 {lab} {shape} x [{B}, {m}, {F}] g [{B}, "
                      f"{m}, {O}] K={CHEB['K'][0]}: {kernel_line(r)}; fold "
                      f"of {r['parts_mb']:.1f} MB of partials "
                      f"{r['fold_ms']:.4f} ms ("
                      f"{100 * r['fold_ms'] / r['ms']:.1f}% of K3) [{gpu}]",
                      flush=True)

    # Phases 8 and 9: the paper's ChebNet served and trained, its
    # operators in f32 (the paper's) and in bf16.
    xs = torch.from_numpy(data["test_data"]).to(dev)
    creqs = list(xs.split(CHEB_B))
    batch = (torch.from_numpy(data["train_data"]).to(dev),
             torch.from_numpy(data["train_labels"]).to(dev))
    cheb = {}
    for lab, dt in DTYPES.items():
        model, cparams = chebnet_model(Ls, dt, dev)
        srv = chebnet_serve_phase(model, cparams, creqs, lab)
        trn = chebnet_train_phase(model, cparams, batch, lab)
        cheb[lab] = {"serve": srv, "train": trn, "net": (model, cparams)}
        if lab == "f32":
            q8 = cheb["int8"] = chebnet_int8_phase(model, cparams, creqs,
                                                   srv["serving"])
            print(f"chebnet serve int8 (compile_serving defaults): "
                  f"{N_REQUESTS} requests of {CHEB_B}, launches (K2, K3) "
                  f"{q8['launches']}, max |card - CPU| "
                  f"{q8['max_abs_err']:.3g}, K=25 int8 chain bit-identical "
                  f"on card and CPU; argmax agreement with f32 "
                  f"{q8['agreement']:.4f} (JAX's {CHEB_INT8_AGREEMENT}; "
                  f"max |int8 - f32| "
                  f"{q8['max_rel_diff']:.3g} of the f32 max); "
                  f"{q8['ms']:.3f} ms per request (the float64 "
                  f"accumulator's {q8['f64_ms']:.3f}) [{gpu}]", flush=True)
        print(f"chebnet serve {lab}: {N_REQUESTS} requests of {CHEB_B}, "
              f"launches (K2, K3) {srv['launches']}, max |served - plain| "
              f"{srv['max_abs_err']:.3g}; {srv['ms']:.3f} ms per request "
              f"(plain {srv['plain_ms']:.3f} ms) [{gpu}]", flush=True)
        print(f"chebnet train {lab}: {TRAIN_STEPS} adam steps, launches "
              f"(K2, K3) {trn['launches']}, losses "
              f"{[round(v, 4) for v in trn['losses']]}; one step vs plain: "
              f"loss rel err {trn['loss_rel_err']:.3g}, gradient err "
              f"{trn['grad_rel_err']:.3g} of max; {trn['ms']:.3f} ms per "
              f"step (plain {trn['plain_ms']:.3f} ms) [{gpu}]", flush=True)

    # Phase 25 (b): the f32 ChebNet's artifact (K2), in this process.
    t0 = time.perf_counter()
    art_k2 = artifact_phase(*cheb["f32"]["net"], creqs[0], creqs,
                            cheb["f32"]["serve"]["serving"],
                            "cheby_conv_fused", 1, False, "chebnet f32 (K2)",
                            tmp.name, gpu)
    art_s += time.perf_counter() - t0

    # Phase 19: the Trainer on the card: the paper's ChebNet (K2, K3)
    # and the GC32 text driver.
    trainer_rec = trainer_phase(Ls, perm, dev, gpu,
                                cheb["f32"]["train"]["ms"])
    text_trainer_phase(gpu)

    # Phases 22-24: flow forecasting on 1,024 regions (K2 and K3 at the
    # gLSTM's 256-wide gates), K2 and K3 at the forecasting geometries,
    # and the paper's other filters (Lanczos through K1).
    t0 = time.perf_counter()
    flow = flow_data()
    flow_rec = flow_phase(flow, dev, gpu)
    flow_k = flow_kernel_phase(flow["L"], dev, gen, gpu)
    flow26 = {k: flow[k] for k in ("splits", "L")}  # phase 26 (d)'s data
    del flow
    filters_phase(Ls, data, dev, gpu)
    lanczos = lanczos_k1_phase(ops["f32"], gen, gpu)
    print(f"phases 22-24: {time.perf_counter() - t0:.1f} s", flush=True)

    # Phase 10: the bench's 50k scattered graph, K4 against its plain
    # version.  fmt="auto" must give the column-streamed BSR operator.
    t0 = time.perf_counter()
    L_s = scattered_graph()
    op32 = device_laplacian(L_s, fmt="auto", device=dev)
    check(isinstance(op32, BlockSparseLaplacian) and op32.col_stream
          and op32.block_shape == (128, 128), "auto format on the scattered "
          f"graph gave {type(op32).__name__} "
          f"(col_stream {getattr(op32, 'col_stream', None)})")
    print(f"scattered graph: {op32.m} nodes, nnz {op32.nnz}, "
          f"{int(op32.cs_groupptr[-1])} blocks of 128x128 with pads, G "
          f"{op32.rows_per_step}, {op32.cs_gcols.numel()} group "
          f"columns, set-up {time.perf_counter() - t0:.1f} s", flush=True)
    s_labels, s_feats = scattered_features(op32.m, 2 * N_REQUESTS + 1)
    s_reqs = [f.to(dev) for f in s_feats[:2 * N_REQUESTS]]
    s_max = float(max(f.abs().max() for f in s_feats[:2 * N_REQUESTS]))
    # Phase 16 for the scattered graph, printed beside its kernels.
    lib["scattered"] = library_phase(csr_operand(L_s, op32.m_padded, dev),
                                     gen, "50k scattered", gpu)
    k4 = {"f32": bsr_kernel_phase(op32, "K4", ("spmm", "hop"), gen,
                                  "K4 f32", lib["scattered"]["f32"])}
    s_bf16 = dataclasses.replace(op32, blocks=op32.blocks.to(torch.bfloat16))
    del op32  # f32 blocks: 3.55 GB
    torch.cuda.empty_cache()
    k4["bf16"] = bsr_kernel_phase(s_bf16, "K4", ("spmm", "hop"), gen,
                                  "K4 bf16", lib["scattered"]["bf16"])
    k4["int8"] = bsr_kernel_phase(
        quantize_block_sparse(s_bf16, sample_x=s_max), "K4", ("spmm", "hop"),
        gen, "K4 int8")
    s_refs = scattered_refs(s_bf16, dev)  # phase 27 (b)'s
    for lab, rec in k4.items():
        print_bsr_kernel(f"{BSR_KERNEL} as K4 (bsr_colstream) {lab}", rec,
                         gpu)
    long_rows = long_rows_phase(dev, gen)

    # Phase 11: the scattered graph's NodeClassifier served and trained.
    s_model = NodeClassifier(s_bf16, FIN, CLASSES, hidden=[], K=K,
                             generator=torch.Generator().manual_seed(0))
    s_served = {}
    for i, mode in enumerate(("bf16", "int8")):
        serving = compile_serving(s_model, s_model.param_tree(), s_reqs[0],
                                  int8=mode == "int8")
        rec = s_served[mode] = bsr_serve_phase(
            serving, s_reqs[i * N_REQUESTS:(i + 1) * N_REQUESTS], "K4",
            f"scattered serve {mode}", timed=True)
        print(f"scattered serve {mode}: {N_REQUESTS} requests, "
              f"{rec['launches']} K4 launches, logits "
              f"{tuple(rec['logits'][0].shape)}, max |served - plain| "
              f"{rec['max_abs_err']:.3g}; {rec['ms']:.3f} ms per request "
              f"(plain {rec['plain_ms']:.3f} ms) [{gpu}]", flush=True)
    # Phase 25 (b): the scattered int8 request's artifact (K4).
    t0 = time.perf_counter()
    art_k4 = artifact_phase(s_model, s_model.param_tree(), s_reqs[0],
                            s_reqs[N_REQUESTS:], s_served["int8"]["serving"],
                            "bsr_colstream", K - 1, True,
                            "50k scattered int8 (K4)", tmp.name, gpu)
    torch.cuda.empty_cache()
    art_s += time.perf_counter() - t0
    s_data = (s_feats[-1].to(dev), s_labels.to(dev),
              torch.ones(s_bf16.m, dtype=torch.bool, device=dev))
    s_train = bsr_train_phase(s_bf16, s_data)
    print(f"scattered train bf16: {TRAIN_STEPS} adam steps, "
          f"{s_train['launches']} K4 launches {s_train['forms']}, losses "
          f"{[round(v, 4) for v in s_train['losses']]}; one step vs plain: "
          f"loss rel err {s_train['loss_rel_err']:.3g}, gradient err "
          f"{s_train['grad_rel_err']:.3g} of max; {s_train['ms']:.3f} ms per "
          f"step (plain {s_train['plain_ms']:.3f} ms), peak memory "
          f"{s_train['peak_gb']:.2f} GiB [{gpu}]", flush=True)

    # Phase 21: bench.py's 50k scattered K=25 chain on the same BSR
    # operator (K4), bf16 and int8.
    Xs = torch.randn(s_bf16.m_padded, FIN, generator=gen,
                     device=dev).to(torch.bfloat16)
    s_chains = {
        "bf16": bsr_chain_phase(s_bf16, Xs, "50k scattered bf16", gpu,
                                lib["scattered"]["bf16"]),
        "int8": bsr_chain_phase(quantize_block_sparse(s_bf16, sample_x=3.0),
                                Xs, "50k scattered int8", gpu)}
    del Xs
    torch.cuda.empty_cache()

    # Phase 12: bsr_csr through each route it ports, then one request
    # through each route's operator.
    t0 = time.perf_counter()
    op8 = device_laplacian(L_s, fmt="bsr", col_stream=False, device=dev)
    check(not op8.col_stream and op8.rows_per_step == 1
          and op8.group_max > 0 and op8.row_max == 0,
          f"col_stream=False layout: G {op8.rows_per_step}, group_max "
          f"{op8.group_max}, row_max {op8.row_max}")
    s_lib = lib["scattered"]
    csr = {"K8 f32": bsr_kernel_phase(op8, "K8", ("spmm",), gen, "K8 f32",
                                      s_lib["f32"])}
    bf8 = dataclasses.replace(op8, blocks=op8.blocks.to(torch.bfloat16))
    del op8
    torch.cuda.empty_cache()
    csr["K8 bf16"] = bsr_kernel_phase(bf8, "K8", ("spmm",), gen, "K8 bf16",
                                      s_lib["bf16"])
    q8 = quantize_block_sparse(bf8, sample_x=s_max)
    csr["K7 int8"] = bsr_kernel_phase(q8, "K7", ("spmm", "hop"), gen,
                                      "K7 int8")
    del q8
    op9 = device_laplacian(L_s, fmt="bsr", chunked_rows=True, device=dev)
    check(op9.row_max > 0 and op9.rows_per_step == 1 and op9.group_max == 0,
          f"chunked_rows layout: row_max {op9.row_max}")
    csr["K9 f32"] = bsr_kernel_phase(op9, "K9", ("spmm",), gen, "K9 f32",
                                     s_lib["f32"])
    bf9 = dataclasses.replace(op9, blocks=op9.blocks.to(torch.bfloat16))
    del op9
    torch.cuda.empty_cache()
    csr["K9 bf16"] = bsr_kernel_phase(bf9, "K9", ("spmm",), gen, "K9 bf16",
                                      s_lib["bf16"])
    op_city = device_laplacian(L, fmt="bsr", col_stream=False,
                               dtype=torch.bfloat16, device=dev)
    check(op_city.rows_per_step > 1, "the city graph's block-CSR layout has "
          f"G = {op_city.rows_per_step}, want more than 1")
    csr["K7 bf16"] = bsr_kernel_phase(op_city, "K7", ("spmm", "hop"), gen,
                                      "K7 bf16", lib["city"]["bf16"])
    print(f"block-CSR layouts: scattered G 1, group_max {bf8.group_max}; "
          f"chunked row_max {bf9.row_max}; city graph "
          f"{op_city.block_cols.numel()} blocks, G {op_city.rows_per_step}, "
          f"group_max {op_city.group_max}; set-up and checks "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for what, rec in csr.items():
        print_bsr_kernel(f"{BSR_KERNEL} as {what} (bsr_csr)", rec, gpu)
    routes = {}
    for key, kernel, rop, req, int8 in (
            ("K8 bf16", "K8", bf8, s_reqs[0], False),
            ("K7 int8", "K7", bf8, s_reqs[0], True),
            ("K9 bf16", "K9", bf9, s_reqs[0], False),
            ("K7 bf16", "K7", op_city, reqs[0], False)):
        model = NodeClassifier(rop, FIN, CLASSES, hidden=[], K=K,
                               generator=torch.Generator().manual_seed(0))
        rec = routes[key] = bsr_serve_phase(
            compile_serving(model, model.param_tree(), req, int8=int8),
            [req], kernel, f"serve through {key}", timed=False)
        print(f"serve through {key}: {rec['launches']} launches, max "
              f"|served - plain| {rec['max_abs_err']:.3g}", flush=True)
    route_launches = {key: {"launches": r["launches"]}
                      for key, r in routes.items()}
    del bf8, bf9, op_city, routes, model
    torch.cuda.empty_cache()

    # Phase 13: K5 and K6 against their plain versions on the 50k city
    # graph, and the in-place hop of K1, K5 and K6.
    t0 = time.perf_counter()
    uni = device_laplacian(L, fmt="banded", ragged=False,
                           dtype=torch.bfloat16, device=dev)
    rag = device_laplacian(L, fmt="banded", use_pallas=False,
                           dtype=torch.bfloat16, device=dev)
    check(uni.use_pallas and not rag.use_pallas and rag.bands_dkw is None,
          "the layouts' operators")
    # The ragged operator reaches K6 as in JAX: built without use_pallas
    # (so without the dkw twin), then given it; int8 quantized first.
    lay_ops = {
        "uniform": {"int8": quantize_banded(uni, sample_x=sample),
                    "bf16": uni, "f32": cast_op(uni)},
        "ragged": {lab: dataclasses.replace(o, use_pallas=True) for lab, o in
                   (("int8", quantize_banded(rag, sample_x=sample)),
                    ("bf16", rag), ("f32", cast_op(rag)))},
    }
    for lay, by in lay_ops.items():
        for lab, o in by.items():
            check(layout_of(o) == lay, f"{lay} {lab}: layout {layout_of(o)}")
    print(f"layouts: uniform W {uni.band_width}, {uni.band.shape[0]} x "
          f"{uni.band.shape[1]} = {uni.band.shape[0] * uni.band.shape[1]} "
          f"blocks; ragged levels {rag.levels}, {rag.band.shape[0]} blocks; "
          f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    lay_checks = {lay: {lab: {
        **band_kernel_check(o, gen, f"{KERNEL_ID[lay]} {lab}", lib["city"]),
        **inplace_phase(o, gen, f"{KERNEL_ID[lay]} {lab}")}
        for lab, o in by.items()} for lay, by in lay_ops.items()}
    for lay, by in lay_checks.items():
        for lab, rec in by.items():
            print_band_kernel(f"band_{lay} ({KERNEL_ID[lay]}) {lab}", rec,
                              gpu)
    k1_inplace = {lab: inplace_phase(ops[lab], gen, f"K1 {lab}")
                  for lab in ("int8", "bf16", "f32")}
    for lab, rec in k1_inplace.items():
        print(f"kernel band_dkw (K1) {lab} C={FIN}: in place "
              f"{rec['hop_inplace_ms']:.4f} ms vs out of place "
              f"{rec['hop_outofplace_ms']:.4f} ms, bit-identical [{gpu}]",
              flush=True)

    # Phase 14: bench.py's K=25 chains, each layout at 50k, the default
    # layout at 100k.
    X = torch.randn(op.m_padded, FIN, generator=gen,
                    device=dev).to(torch.bfloat16)
    x_max = float(X.abs().max())
    chains = {}
    for lay, o in (("dkw", op), ("ragged", lay_ops["ragged"]["bf16"]),
                   ("uniform", uni)):
        q = quantize_banded(_plain_banded(o) if lay == "ragged" else o,
                            sample_x=x_max)
        chains[lay] = {
            "bf16": chain_phase(o, X, f"50k {lay} bf16", gpu),
            "int8": chain_phase(dataclasses.replace(q, use_pallas=True), X,
                                f"50k {lay} int8", gpu)}
    del X, q
    t0 = time.perf_counter()
    L100, _ = graphs.city_graph(SIDE_100K, k=KNN, seed=0)
    op100 = device_laplacian(L100, fmt="auto", dtype=torch.bfloat16,
                             device=dev)
    check(isinstance(op100, BandedLaplacian) and layout_of(op100) == "dkw",
          f"100k auto format gave {type(op100).__name__}")
    print(f"graph 100k: {op100.m} nodes, nnz {op100.nnz}, levels "
          f"{op100.levels}, {op100.band.shape[0]} band blocks, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    X = torch.randn(op100.m_padded, FIN, generator=gen,
                    device=dev).to(torch.bfloat16)
    chains["100k"] = {
        "bf16": chain_phase(op100, X, "100k dkw bf16", gpu),
        "int8": chain_phase(quantize_banded(
            op100, sample_x=float(X.abs().max())), X, "100k dkw int8", gpu)}
    del op100, X, L100
    torch.cuda.empty_cache()

    # Phase 15: the NodeClassifier on the uniform operator (K5), served
    # and trained, and requests through the ragged one (K6).
    u_model = NodeClassifier(uni, FIN, CLASSES, hidden=[], K=K,
                             generator=torch.Generator().manual_seed(0))
    u_served = {mode: compile_serving(u_model, u_model.param_tree(), reqs[0],
                                      int8=mode == "int8")
                for mode in ("bf16", "int8")}
    u_serve = banded_serve_phase(
        u_served, {"bf16": reqs[:N_REQUESTS], "int8": reqs[N_REQUESTS:]},
        banded_uniform, "uniform serve", gpu)
    u_lat = {}
    for mode, srv in u_served.items():
        twin = compile_serving(map_operators(srv.model, _plain_twin),
                               srv.params, reqs[0], int8=False)
        u_lat[mode] = {"ms": cuda_ms(lambda s=srv: s(reqs[0]), 5),
                       "plain_ms": cuda_ms(lambda t=twin: t(reqs[0]), 2)}
        print(f"uniform request latency {mode}: {u_lat[mode]['ms']:.3f} ms "
              f"(plain twin {u_lat[mode]['plain_ms']:.3f} ms) [{gpu}]",
              flush=True)
    u_train = train_phase(uni, 1.0, nc_data, "uniform bf16",
                          kernel=banded_uniform)
    print(f"train uniform bf16: {TRAIN_STEPS} adam steps, "
          f"{u_train['launches']} K5 launches {u_train['forms']}, losses "
          f"{[round(v, 4) for v in u_train['losses']]}; one step vs plain: "
          f"loss rel err {u_train['loss_rel_err']:.3g}, gradient err "
          f"{u_train['grad_rel_err']:.3g} of max; {u_train['ms']:.3f} ms per "
          f"step (plain {u_train['plain_ms']:.3f} ms), peak memory "
          f"{u_train['peak_gb']:.2f} GiB [{gpu}]", flush=True)
    r_model = NodeClassifier(lay_ops["ragged"]["bf16"], FIN, CLASSES,
                             hidden=[], K=K,
                             generator=torch.Generator().manual_seed(0))
    r_served = {mode: compile_serving(
        map_operators(r_model, lambda _, o=lay_ops["ragged"][mode]: o),
        r_model.param_tree(), reqs[0], int8=False)
        for mode in ("bf16", "int8")}
    r_serve = banded_serve_phase(
        r_served, {"bf16": reqs[:1], "int8": reqs[N_REQUESTS:N_REQUESTS + 1]},
        banded_ragged, "ragged serve", gpu)
    r_lat = {mode: cuda_ms(lambda s=srv: s(reqs[0]), 5)
             for mode, srv in r_served.items()}
    for mode, ms in r_lat.items():
        print(f"ragged request latency {mode}: {ms:.3f} ms [{gpu}]")

    if args.profile_dir:
        profile_phase(served, reqs[0], lat, args.profile_dir, gpu)
        train_profile_phase(trains["bf16"]["run"], trains["bf16"]["ms"],
                            args.profile_dir, gpu)
        profile_phase({"chebnet_f32": cheb["f32"]["serve"]["serving"]},
                      creqs[0], {"chebnet_f32": cheb["f32"]["serve"]["ms"]},
                      args.profile_dir, gpu)
        chebnet_profile_phase(cheb["f32"]["train"]["run"],
                              cheb["f32"]["train"]["ms"], args.profile_dir,
                              gpu)
        chebnet_profile_phase(trainer_rec["run"], trainer_rec["ms"],
                              args.profile_dir, gpu,
                              mode="trainer_chebnet_f32",
                              optimizer=("optax chain", "train.optimizer"))
        chebnet_profile_phase(flow_rec["resgnn"]["run"],
                              flow_rec["resgnn"]["ms"], args.profile_dir,
                              gpu, mode="trainer_resgnn_f32",
                              optimizer=("optax chain", "train.optimizer"),
                              k2_forward=RESGNN_FWD_K2,
                              stacked="conv_init, conv_out (stacked)")
        profile_phase({f"scattered_{m}": r["serving"]
                       for m, r in s_served.items()}, s_reqs[0],
                      {f"scattered_{m}": r["ms"] for m, r in s_served.items()},
                      args.profile_dir, gpu)
        train_profile_phase(s_train["run"], s_train["ms"], args.profile_dir,
                            gpu, mode="scattered_train_bf16",
                            parts_of=BSR_TRAIN_PARTS)
        profile_phase({f"uniform_{m}": srv for m, srv in u_served.items()},
                      reqs[0], {f"uniform_{m}": r["ms"]
                                for m, r in u_lat.items()},
                      args.profile_dir, gpu)
        profile_phase({f"ragged_{m}": srv for m, srv in r_served.items()},
                      reqs[0], {f"ragged_{m}": ms for m, ms in r_lat.items()},
                      args.profile_dir, gpu)
        train_profile_phase(u_train["run"], u_train["ms"], args.profile_dir,
                            gpu, mode="uniform_train_bf16",
                            parts_of=train_parts("uniform"))
        for graph, rec in lib.items():
            for lab, call in rec["calls"].items():
                profile_phase({f"library_{graph}_{lab}": call}, None,
                              {f"library_{graph}_{lab}": rec[lab]},
                              args.profile_dir, gpu)

    # Phase 18: the probes against their plain versions, then timed.
    t0 = time.perf_counter()
    probe_errs = probe_check_phase(dev)
    for name, (e, ex) in probe_errs.items():
        print(f"probe check {name}: max_abs_err {e:.3g}"
              + ("" if ex is None else f", extra {ex:.3g}"), flush=True)
    probe_rows = probe_time_phase(probe_errs, gpu)
    print(f"probes: checks and timing {time.perf_counter() - t0:.1f} s",
          flush=True)

    # Phase 20: the 20NEWS topology cell.
    news_phase(dev, gpu)

    # Phase 25 (c): the node-classification driver and its artifact.
    t0 = time.perf_counter()
    art_driver = driver_phase(tmp.name, gpu)
    art_s += time.perf_counter() - t0
    tmp.cleanup()
    print(f"phase 25 (serving artifacts): {art_s:.1f} s", flush=True)

    # Phase 26: the node-sharded operators, K1/K5/K6 on halo-extended x.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d26:
        halo_a = sharded_one_rank_phase(L, op, chains, dev, gpu)
        halo_b = sharded_ranks_phase(L, d26, gpu)
        halo_c = sharded_driver_phase(art_driver["test_acc"], gpu)
        halo_d = sharded_trainer_phase(flow26, dev, d26, gpu)
    print(f"phase 26 (node-sharded operators): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # Phase 27: the sparse halo operators, K8 and K5 on halo-extended x,
    # and the BCOO format.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d27:
        sparse_ab = sparse_ranks_phase(L, L_s, s_refs, d27, gpu)
    del s_refs
    sparse_c = sparse_driver_phase(art_driver["test_acc"], gpu)
    bcoo_phase(L, reqs, dev, gpu)
    print(f"phase 27 (sparse halo operators, BCOO): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # Phase 28: the banded operators at other block shapes; Graclus.  Its
    # plain versions gather windows of several GB (a 32x32 int8 window in
    # float64): the cached blocks of the earlier phases go first.
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ref50 = {("dkw", lab): checks[lab]["ms"] for lab in checks}
    ref50.update({(lay, lab): rec["ms"] for lay, by in lay_checks.items()
                  for lab, rec in by.items()})
    shape_a = shape_kernel_phase(L, SHAPES_50K, "50k", gen, lib["city"],
                                 ref50, dev, gpu)
    L40, _ = graphs.city_graph(SIDE_SMALL, k=KNN, seed=0)
    small = shape_kernel_phase(L40, SHAPES_SMALL, f"city{SIDE_SMALL}", gen,
                               None, {}, dev, gpu)
    ref40 = {(lay, lab): small[((128, 128), lay, lab)]["ms"]
             for _, lay, lab in small}
    for (shape, lay, lab), rec in small.items():
        rec["ms_128"] = ref40[(lay, lab)]
    shape_a.update({k: v for k, v in small.items() if k[0] != (128, 128)})
    t_a = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d28:
        shape_b = shape_model_phase(L, nc_data, reqs, logits, d28, gpu)
    graclus_phase(positions, gpu)
    print(f"phase 28 (a): {t_a:.1f} s", flush=True)
    print(f"phase 28 (other block shapes, Graclus): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    SHAPE_B = (SERVE_BLOCK, SERVE_BLOCK)

    def shape_b_launches(lay, lab):
        """Phase 28 (b)'s launches of ``lay``'s kernel in ``lab``: the
        requests, and for K1 bf16 the training step."""
        if lay != "dkw":
            return shape_b[f"{lay}_launches"][lab]
        return shape_b["launches"][lab] + (
            shape_b["train_launches"] if lab == "bf16" else 0)

    def sparse64_keys():
        """Phase 28 (c): the banded sparse-halo shard at SHAPE_B."""
        ranks = [r["banded64"] for r in sparse_ab["ranks"]]
        return {"sparse_halo_64_launches_per_rank": [
                    sum(sum(v.values()) for v in r["launches"].values())
                    for r in ranks],
                "sparse_halo_64_H": ranks[0]["H"],
                "sparse_halo_64_max_abs_err": {
                    lab: max(r["max_abs_err"][lab] for r in ranks)
                    for lab in ranks[0]["max_abs_err"]},
                "sparse_halo_64_rows_max_abs_err": {
                    lab: max(r["rows_max_abs_err"][lab] for r in ranks)
                    for lab in ranks[0]["rows_max_abs_err"]},
                "sparse_halo_64_exchange_ms_gloo_one_card": [
                    r["exchange_ms_gloo_one_card"] for r in ranks]}

    def shape_keys(lay, lab):
        """Phase 28 (a)'s numbers of one layout and dtype at every other
        block shape, by shape (the 50k graph's first), beside the
        128x128 time on the same graph."""
        out = {}
        for (shape, ly, lb), r in shape_a.items():
            if (ly, lb) != (lay, lab):
                continue
            out[f"{r['graph']}_{_shape_tag(shape)}"] = {
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "hop_ms": r["hop_ms"], "max_abs_err": r["max_abs_err"],
                "rows_max_abs_err": r["rows_max_abs_err"],
                "bound_ms": r["roofline"]["bound_us"] / 1e3,
                "bound_by": r["roofline"]["bound_by"],
                "hop_inplace_ms": r["hop_inplace_ms"],
                "library_ms": r["library_ms"], "ms_128": r["ms_128"]}
        return {"other_block_shapes": out}

    def sparse_keys(fmt):
        """Phase 27's numbers for the kernel row of ``fmt``'s route:
        launches per rank of (a) (and (b) for bsr), the errors, the
        exchange, the driver's launches per step."""
        ranks = sparse_ab["ranks"]
        halo = "sparse" if fmt == "bsr" else "sparse-banded"
        out = {
            "sparse_halo_launches_per_rank": [
                sum(sum(v.values()) for v in r[fmt]["launches"].values())
                + (sum(sum(v.values()) for v in
                       r["scattered"]["launches"].values())
                   if fmt == "bsr" else 0) for r in ranks],
            "sparse_halo_H": ranks[0][fmt]["H"],
            "sparse_halo_max_abs_err": {
                lab: max(r[fmt]["max_abs_err"][lab] for r in ranks)
                for lab in ranks[0][fmt]["max_abs_err"]},
            "sparse_halo_rows_max_abs_err": {
                lab: max(r[fmt]["rows_max_abs_err"][lab] for r in ranks)
                for lab in ranks[0][fmt]["rows_max_abs_err"]},
            "sparse_halo_bytes_per_hop_bf16": [r[fmt]["bytes_per_hop"]
                                               for r in ranks],
            "sparse_halo_exchange_ms_gloo_one_card": [
                r[fmt]["exchange_ms_gloo_one_card"] for r in ranks],
            "sparse_halo_driver_launches_per_step": sparse_c[halo][
                "launches_per_step"],
            "sparse_halo_driver_ms_per_step_gloo_one_card": sparse_c[halo][
                "ms_per_step"],
            "sparse_halo_driver_test_acc": sparse_c[halo]["test_acc"]}
        if fmt == "bsr":
            sc = [r["scattered"] for r in ranks]
            out.update({
                "sparse_halo_scattered_H": sc[0]["H"],
                "sparse_halo_scattered_blocks_per_rank": [
                    r["blocks"] for r in sc],
                "sparse_halo_scattered_max_abs_err": {
                    lab: max(r["max_abs_err"][lab] for r in sc)
                    for lab in sc[0]["max_abs_err"]},
                "sparse_halo_scattered_bytes_per_hop_bf16": [
                    r["bytes_per_hop"] for r in sc],
                "sparse_halo_scattered_exchange_ms_gloo_one_card": [
                    r["exchange_ms_gloo_one_card"] for r in sc]})
        return out

    def halo_keys(lab):
        """Phase 26's numbers for one kernel row: ``lab`` is phase 26
        (b)'s label of the kernel and dtype."""
        ranks = halo_b["ranks"]
        out = {
            "halo_launches_per_rank": [
                sum(r["launches"].get(lab, {}).values()) for r in ranks],
            "halo_max_abs_err": max(r["max_abs_err"][lab] for r in ranks),
            "halo_rows_max_abs_err": max(r["rows_max_abs_err"][lab]
                                         for r in ranks),
            "halo_exchange_ms_gloo_one_card": [
                r["exchange_ms_gloo_one_card"] for r in ranks],
            "halo_bytes_per_hop_bf16": [r["bytes_per_hop"] for r in ranks],
            "halo_bytes_formula_bf16": ranks[0]["bytes_formula"]}
        if lab in halo_a["us_per_spmm"]:
            out.update({
                "halo_one_rank_chain_us_per_spmm": halo_a["us_per_spmm"][lab],
                "halo_one_rank_hop_us_per_spmm":
                    halo_a["hop_us_per_spmm"][lab],
                "halo_one_rank_single_chip_us_per_spmm":
                    halo_a["plain_us_per_spmm"][lab],
                "halo_one_rank_split_chain_us_per_spmm":
                    halo_a["us_per_spmm"][lab + "_split"],
                "halo_one_rank_max_abs_err": max(
                    halo_a["max_abs_err"][lab],
                    halo_a["max_abs_err"][lab + "_split"])})
        if lab == "bf16":
            out.update({
                "halo_f32_max_abs_err": max(r["max_abs_err"]["f32"]
                                            for r in ranks),
                "halo_f32_rows_max_abs_err": max(
                    r["rows_max_abs_err"]["f32"] for r in ranks),
                "halo_adjoint_f32_max_abs_err": max(
                    r["max_abs_err"]["adjoint_f32"] for r in ranks),
                "halo_driver_k1_launches_per_step": halo_c["k1_per_step"],
                "halo_driver_ms_per_step_gloo_one_card":
                    halo_c["ms_per_step"],
                "halo_driver_test_acc": halo_c["test_acc"],
                "halo_trainer_max_abs_err": halo_d["max_abs_err"]})
        return out

    def band_row(name, lay, lab, rec, launches, **extra):
        """A banded kernel's row: the sparse bound as ``bound_ms``, the
        block format's work and the row walk's plain version beside."""
        rows = {k: rec[k] for k in ("rows_max_abs_err", "rows_plain_ms",
                                    "hop_rows_plain_ms") if k in rec}
        return {"name": name, "route": "cuda", "source": SOURCE,
                "kernel": BAND_KERNEL[lay], "replaces": REPLACES[lay],
                "launches": launches, "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                **bound_keys(rec["roofline"]),
                **work_keys(rec["block_roofline"]),
                "library_ms": rec["library_ms"], "hop_ms": rec["hop_ms"],
                "hop_plain_ms": rec["hop_plain_ms"],
                "hop_bound_ms": rec["hop_roofline"]["bound_us"] / 1e3,
                **rows, **extra}

    def trainer_keys(i):
        """Phase 19's Trainer: launches of K2 (i = 0) or K3 (i = 1) per
        training step, its step time from CUDA events and fit's."""
        r = trainer_rec
        per_step = (r["launches"][i] - (r["eval_launches"] if i == 0
                                        else 0)) / r["steps"]
        return {"trainer_launches": r["launches"][i],
                "trainer_launches_per_step": per_step,
                "trainer_ms_per_step": r["ms"],
                "trainer_fit_ms_per_step": r["t_step_ms"]}

    def flow_keys(kernel, lab):
        """Phase 23's forecasting geometries of K2 or K3 in ``lab`` and,
        in f32, phase 22's launches and ms per training step."""
        out = {}
        shapes = FLOW_K2_SHAPES if kernel == "K2" else FLOW_K3_SHAPES
        for name in shapes:
            r = flow_k[f"{lab}_{kernel}_{name}"]
            key = "flow_" + name.replace("->", "_to_").replace(",", "_")
            out.update({f"{key}_{k}": r[k] for k in ("ms", "plain_ms",
                                                     "max_abs_err")})
            out[f"{key}_bound_ms"] = r["bound"]["bound_us"] / 1e3
            out[f"{key}_geometry"] = {k: r["geometry"][k] for k in (
                "np", "nop", "samples", "groups", "cluster", "rows")}
        if lab == "f32":
            i = 0 if kernel == "K2" else 1
            for model in ("resgnn", "glstm"):
                r = flow_rec[model]
                out[f"{model}_launches_per_step"] = (
                    RESGNN_STEP_LAUNCHES if model == "resgnn"
                    else GLSTM_STEP_LAUNCHES)[i]
                out[f"{model}_ms_per_step"] = r["ms"]
        return out

    def flow_launches(i):
        """Phase 22's launches of K2 (i = 0) or K3 (i = 1) in its fits."""
        return sum(flow_rec[m]["launches"][i] for m in ("resgnn", "glstm"))

    def chain_keys(lay, lab):
        c = chains[lay][lab]
        return {"chain_launches_per_block": c["launches"],
                "chain_us_per_spmm": c["us_per_spmm"],
                "chain_plain_us_per_spmm": c["plain_us_per_spmm"],
                "chain_gedges_per_s": c["gedges_per_s"]}

    def f32_keys(rec):
        return {"f32_ms": rec["ms"], "f32_plain_ms": rec["plain_ms"],
                "f32_max_abs_err": rec["max_abs_err"],
                "f32_bound_ms": rec["roofline"]["bound_us"] / 1e3,
                "f32_block_work_ms": rec["block_roofline"]["bound_us"] / 1e3,
                "f32_library_ms": rec["library_ms"]}

    def bsr_keys(rec, library_ms):
        """A row kernel's numbers: the sparse bound as ``bound_ms``, the
        block format's work and the block walk's plain time beside."""
        out = {}
        for pre in ("", "hop_"):
            if pre + "ms" not in rec:
                continue
            r, b = rec[pre + "roofline"], rec[pre + "block_roofline"]
            out.update({
                pre + "ms": rec[pre + "ms"],
                pre + "plain_ms": rec[pre + "plain_ms"],
                pre + "block_plain_ms": rec[pre + "block_plain_ms"],
                pre + "bound_ms": r["bound_us"] / 1e3,
                pre + "bound_by": r["bound_by"],
                pre + "block_work_ms": b["bound_us"] / 1e3,
                pre + "block_work_by": b["bound_by"]})
        return {"max_abs_err": rec["max_abs_err"],
                "block_max_abs_err": rec["block_max_abs_err"], **out,
                "library_ms": library_ms}

    record = {"kernels": [
        band_row(f"band_dkw_{lab}", "dkw", lab, checks[lab], launches[lab],
                 request_ms=lat[lab], **chain_keys("dkw", lab),
                 chain_100k_launches_per_block=chains["100k"][lab][
                     "launches"],
                 chain_100k_us_per_spmm=chains["100k"][lab]["us_per_spmm"],
                 **k1_inplace[lab],
                 **({"artifact_launches": art_k1["launches"],
                     "artifact_load_s": art_k1["load_s"],
                     "artifact_export_s": art_k1["export_s"],
                     "loaded_request_ms": art_k1["ms"],
                     "loaded_inprocess_request_ms": art_k1["inprocess_ms"],
                     "compiled_in_turns_request_ms": art_k1["compiled_ms"],
                     "driver_artifact_launches": art_driver["launches"],
                     "driver_artifact_request_ms": art_driver["ms"]}
                    if lab == "int8" else {}),
                 **halo_keys(lab),
                 **({"train_launches_per_step":
                     trains["bf16"]["launches"] // TRAIN_STEPS,
                     **f32_keys(checks["f32"]),
                     "lanczos_f32_launches_per_call": lanczos["launches"],
                     "lanczos_f32_ms": lanczos["ms"],
                     "lanczos_f32_plain_ms": lanczos["plain_ms"],
                     "lanczos_f32_max_abs_err": lanczos["max_abs_err"]}
                    if lab == "bf16" else {}))
        for lab in ("int8", "bf16")
    ] + [
        {"name": f"band_dkw_hop_c_{lab}", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["dkw"],
         "launches": trains[lab]["forms"]["hop_c"],
         "kernel": BAND_KERNEL["dkw"],
         "max_abs_err": checks[lab]["hop_c_max_abs_err"],
         "rows_max_abs_err": checks[lab]["hop_c_rows_max_abs_err"],
         "ms": checks[lab]["hop_c_ms"],
         "plain_ms": checks[lab]["hop_c_plain_ms"],
         "rows_plain_ms": checks[lab]["hop_c_rows_plain_ms"],
         **bound_keys(checks[lab]["hop_c_roofline"]),
         **work_keys(checks[lab]["hop_c_block_roofline"]),
         "library_ms": None,
         "train_ms_per_step": trains[lab]["ms"],
         "train_plain_ms_per_step": trains[lab]["plain_ms"]}
        for lab in ("bf16", "f32")
    ] + [
        band_row(f"band_uniform_{lab}", "uniform", lab,
                 lay_checks["uniform"][lab],
                 u_serve["launches"][lab],
                 request_ms=u_lat[lab]["ms"],
                 request_plain_ms=u_lat[lab]["plain_ms"],
                 hop_inplace_ms=lay_checks["uniform"][lab]["hop_inplace_ms"],
                 **chain_keys("uniform", lab),
                 **(halo_keys("K5") if lab == "bf16" else {}),
                 **(sparse_keys("banded") if lab == "bf16" else {}),
                 **({"hop_c_ms": lay_checks["uniform"][lab]["hop_c_ms"],
                     "train_launches_per_step":
                         u_train["launches"] // TRAIN_STEPS,
                     "train_ms_per_step": u_train["ms"],
                     "train_plain_ms_per_step": u_train["plain_ms"],
                     **f32_keys(lay_checks["uniform"]["f32"])}
                    if lab == "bf16" else {}))
        for lab in ("int8", "bf16")
    ] + [
        band_row(f"band_ragged_{lab}", "ragged", lab,
                 lay_checks["ragged"][lab],
                 r_serve["launches"][lab],
                 request_ms=r_lat[lab],
                 hop_inplace_ms=lay_checks["ragged"][lab]["hop_inplace_ms"],
                 **chain_keys("ragged", lab),
                 **(halo_keys("K6") if lab == "bf16" else {}),
                 **({"hop_c_ms": lay_checks["ragged"][lab]["hop_c_ms"],
                     **f32_keys(lay_checks["ragged"]["f32"])}
                    if lab == "bf16" else {}))
        for lab in ("int8", "bf16")
    ] + [
        band_row(f"band_{lay}_{_shape_tag(SHAPE_B)}_{lab}", lay, lab,
                 shape_a[(SHAPE_B, lay, lab)], shape_b_launches(lay, lab),
                 block_shape=list(SHAPE_B),
                 ms_128=shape_a[(SHAPE_B, lay, lab)]["ms_128"],
                 hop_inplace_ms=shape_a[(SHAPE_B, lay, lab)][
                     "hop_inplace_ms"],
                 request_ms=(shape_b["request_ms"] if lay == "dkw" else
                             shape_b[f"{lay}_request_ms"])[lab],
                 logits_equal_to_128=shape_b["same_as_128"].get(
                     lab if lay == "dkw" else f"{lay}_{lab}"),
                 logits_max_diff_from_128=shape_b["diff_from_128"][
                     lab if lay == "dkw" else f"{lay}_{lab}"],
                 **shape_keys(lay, lab),
                 **({"artifact_launches": shape_b["artifact"]["launches"],
                     "loaded_request_ms": shape_b["artifact"]["ms"]}
                    if (lay, lab) == ("dkw", "int8") else {}),
                 **({"train_launches_per_step": shape_b["train_launches"],
                     "train_ms_per_step": shape_b["train_ms"],
                     **f32_keys(shape_a[(SHAPE_B, lay, "f32")])}
                    if (lay, lab) == ("dkw", "bf16") else
                    {**f32_keys(shape_a[(SHAPE_B, lay, "f32")]),
                     **sparse64_keys()} if (lay, lab) == ("uniform", "bf16")
                    else {**f32_keys(shape_a[(SHAPE_B, lay, "f32")])}
                    if lab == "bf16" else {}))
        for lay in LAYOUT_KERNELS for lab in ("int8", "bf16")
    ] + [
        {"name": f"cheby_conv_fused_{lab}", "route": "cuda",
         "source": CHEB_SOURCE, "kernel": "cheby_conv_kernel<kConvTap>",
         "replaces": CHEB_REPLACES["K2"],
         "launches": (cheb[lab]["serve"]["launches"][0]
                      + cheb[lab]["train"]["launches"][0]
                      + (trainer_rec["launches"][0] + flow_launches(0)
                         if lab == "f32" else 0)),
         **(trainer_keys(0) if lab == "f32" else {}),
         **flow_keys("K2", lab),
         "max_abs_err": kchecks[f"{lab}_bench"]["max_abs_err"],
         "ms": kchecks[f"{lab}_bench"]["ms"],
         "plain_ms": kchecks[f"{lab}_bench"]["plain_ms"],
         **bound_keys(kchecks[f"{lab}_bench"]["bound"]), "library_ms": None,
         **{f"{shape}_{k}": kchecks[f"{lab}_{shape}"][k]
            for shape in ("layer1", "dx")
            for k in ("ms", "plain_ms", "max_abs_err")},
         **{f"{shape}_bound_ms": kchecks[f"{lab}_{shape}"]["bound"][
             "bound_us"] / 1e3 for shape in ("layer1", "dx")},
         "request_ms": cheb[lab]["serve"]["ms"],
         "request_plain_ms": cheb[lab]["serve"]["plain_ms"],
         **({"artifact_launches": art_k2["launches"],
             "loaded_request_ms": art_k2["ms"],
             "compiled_in_turns_request_ms": art_k2["compiled_ms"]}
            if lab == "f32" else {}),
         "train_ms_per_step": cheb[lab]["train"]["ms"],
         "train_plain_ms_per_step": cheb[lab]["train"]["plain_ms"]}
        for lab in DTYPES
    ] + [
        {"name": f"cheby_dw_fused_{lab}", "route": "cuda",
         "source": CHEB_SOURCE, "kernel": "cheby_conv_kernel<kDwTap>",
         "replaces": CHEB_REPLACES["K3"],
         "launches": (cheb[lab]["train"]["launches"][1]
                      + (trainer_rec["launches"][1] + flow_launches(1)
                         if lab == "f32" else 0)),
         **(trainer_keys(1) if lab == "f32" else {}),
         **flow_keys("K3", lab),
         "max_abs_err": kchecks[f"{lab}_bench_K3"]["max_abs_err"],
         "ms": kchecks[f"{lab}_bench_K3"]["ms"],
         "plain_ms": kchecks[f"{lab}_bench_K3"]["plain_ms"],
         **bound_keys(kchecks[f"{lab}_bench_K3"]["bound"]),
         "library_ms": None,
         "fold_ms": kchecks[f"{lab}_bench_K3"]["fold_ms"],
         **{f"layer1_{k}": kchecks[f"{lab}_layer1_K3"][k]
            for k in ("ms", "plain_ms", "max_abs_err", "fold_ms")},
         "layer1_bound_ms": kchecks[f"{lab}_layer1_K3"]["bound"][
             "bound_us"] / 1e3}
        for lab in DTYPES
    ] + [
        {"name": f"{BSR_KERNEL}_K4_{lab}", "route": "cuda",
         "source": BSR_SOURCE, "replaces": BSR_REPLACES["K4"],
         "wrapper": "bsr_colstream",
         "launches": (s_served[lab]["launches"]
                      + (s_train["launches"] if lab == "bf16" else 0)),
         **bsr_keys(k4[lab], lib["scattered"][lab]),
         "long_rows_max_abs_err": long_rows[lab],
         "chain_launches_per_block": s_chains[lab]["launches"],
         "chain_us_per_spmm": s_chains[lab]["us_per_spmm"],
         "chain_ns_per_block": s_chains[lab]["ns_per_block"],
         "chain_gedges_per_s": s_chains[lab]["gedges_per_s"],
         "request_ms": s_served[lab]["ms"],
         "request_plain_ms": s_served[lab]["plain_ms"],
         **({"artifact_launches": art_k4["launches"],
             "loaded_request_ms": art_k4["ms"],
             "compiled_in_turns_request_ms": art_k4["compiled_ms"]}
            if lab == "int8" else {}),
         **({"train_ms_per_step": s_train["ms"],
             "train_plain_ms_per_step": s_train["plain_ms"],
             **{"f32_" + k: v for k, v in bsr_keys(
                 k4["f32"], lib["scattered"]["f32"]).items()},
             "f32_long_rows_max_abs_err": long_rows["f32"]}
            if lab == "bf16" else {})}
        for lab in ("bf16", "int8")
    ] + [
        {"name": f"{BSR_KERNEL}_{key.replace(' ', '_')}", "route": "cuda",
         "source": BSR_SOURCE, "replaces": BSR_REPLACES[key[:2]],
         "wrapper": "bsr_csr", "launches": rec["launches"],
         **bsr_keys(csr[key], lib["city" if key == "K7 bf16"
                                  else "scattered"][key.split()[1]]),
         **({"f32_" + k: v for k, v in bsr_keys(
             csr[f"{key[:2]} f32"], lib["scattered"]["f32"]).items()}
            if f"{key[:2]} f32" in csr else {}),
         **(sparse_keys("bsr") if key == "K8 bf16" else {})}
        for key, rec in route_launches.items()
    ] + [
        {"name": kernel, "route": "cuda", "source": QUANT_SOURCE,
         "kernel": kernel, "replaces": QUANT_REPLACES,
         "wrapper": f"{side}_int8",
         # Phase 4's 4 int8 requests of one conv: 1 and K a request.
         "launches": conv_launches[side == "dequantize"],
         "max_abs_err": 0.0,
         **{k: conv_rec[f"{pre}_f32_device"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": conv_rec[f"{pre}_f32_device"].get("library_ms"),
         **{f"{k}_{lab}_{kind}": conv_rec[f"{pre}_{lab}_{kind}"][k]
            for lab in DTYPES for kind in ("device", "float")
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")
            if (lab, kind) != ("f32", "device")
            and k in conv_rec[f"{pre}_{lab}_{kind}"]}}
        for side, pre, kernel in (("quantize", "quant", "quant_kernel"),
                                  ("dequantize", "dequant",
                                   "dequant_kernel"))
    ] + probe_rows}
    for row in record["kernels"]:
        check(row["launches"] > 0, f"{row['name']}: no launch on its path")
    print(json.dumps(record))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
