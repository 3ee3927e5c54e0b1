#!/usr/bin/env python3
"""Prove on one NVIDIA GPU that the PyTorch/CUDA port starts and is right.

    python3 chip_smoke.py

Phases, each printing one JSON line that carries the card's name and power
limit (as `nvidia-smi --query-gpu=name,power.limit` reports them):

1. build    - nvcc builds every kernel of `deeplearning4j_tpu_torch/kernels/
              csrc` for sm_90a (one nvcc per source, all at once), and
              prints each kernel's `-Xptxas -v` lines, and apart those of
              the tensor-core kernels (`stream_fwd_wgmma_kernel`,
              `stream_dq_wgmma_kernel`, `stream_dkv_wgmma_kernel`:
              registers, shared memory, spills), by schedule: `<D, list>`
              for rows 4 and 7, `<D, rows>` for rows 3, 5 and 6.
2. kernels  - each hand-written kernel at its main path's shapes (serving:
              the prefill and decode shapes; training: B=16, T=1024, 8
              heads of 64, the LM step's 16,384 LayerNorm rows, and the 24
              layer vertices' 66 tensors of Adam params and state, one
              `apply_step` as the step runs it and one `dispatch` per
              vertex in the deltas mode; LeNet's 8 tensors of Nesterovs
              params and velocity, one `apply_step`), in bf16
              and f32 (the update kernel takes f32 only), against its plain
              PyTorch version on the card (rtol = atol = 4e-2 in bf16, 1e-4
              in f32 with TF32 off), timed with CUDA events (median of 25
              after 5 warm-up runs) beside the plain version, the least
              time the card could take (`bound_ms`) and one PyTorch library
              call where one computes the same function (`library_ms`, a
              yardstick the port never calls), and the host time a call
              costs its caller (`host_ms`, 50 calls back to back; the
              library call's too), and the bound over the device time
              (`bound_share_by_device`). The paged decode attention (row
              8) runs at two cursors: the slots mid-generation and every
              slot at 1023 (beside the latter, SDPA over the same keys
              gathered beforehand into a dense cache, a reference point
              that omits the gather); then with SPEC_K + 1 = 5 query rows
              (the speculative verify) at the first cursors, and over the
              long server's 512 pages a slot (a pool of 2,049 pages) at
              cursors 29,990-30,016 with 1 and 5 query rows; every row 8
              case is also held row by row (o at 1e-2 / 1e-4 of its norm:
              past a few hundred keys |o| is below 4e-2). The flash rows
              3, 5 and 6 are also held row by row (o at 1e-2 / 1e-4 of its
              norm, lse at 1e-4; dq from row 1, dk, dv at 1.2e-2 / 1e-4 of
              max(norm, 0.1 x the median row norm)) and name their form
              (`variant`). Rows 5 and 6 run causal (the LM's step) and
              non-causal (the transformer classifier's unmasked step) at
              [16, 1024, 8, 64].
3. serve    - the widest `transformer_lm` the repo runs (V=8192, d=512, 8
              heads, 4 blocks, bf16 compute over f32 params, seeded random
              weights) behind the port's `InferenceServer` with paged KV
              (64-token pages, 4 slots, prefix cache): eight concurrent
              `POST /generate`, one a repeated prompt that must hit the
              prefix cache. Every response is checked, and every kernel's
              launch count must match the work the scheduler did, with 0
              calls of any plain version and 0 launches of the training
              kernels; every prefill's row 3 on the tensor-core form.
4. parity   - the same weights on the CPU through the plain versions: the
              first-token distribution and 4 decode steps of one prompt
              agree with the card's within 4e-2 (the card's prefill on row
              3's tensor-core form).
5. train    - the same model (no decode cache) trained with
              `ComputationGraph.fit` at `bench.py:1116`'s batch: B=16,
              T=1024, Adam, int64 ids whose next id is a fixed permutation
              of the current one (learnable), int32 labels; 3 warm-up and
              20 timed steps over 2 batches. Scores finite and falling (the
              last 3 average at least 5% under the first), and per step
              exactly 9 LayerNorm, 4 flash forward-with-lse, 4 dq, 4 dk/dv
              (all 12 on the tensor-core form) and 1 fused-update launch
              (all 66 tensors), 0 inference-flash launches, 0 plain calls.
6. train_parity - one `fit` step of the same model at B=2 on the card and
              on the CPU (plain versions): scores within 4e-2 relative and,
              per layer vertex, Adam's m (= 0.1 * grad) within 4e-2 of the
              CPU's largest |m| there (a kernel wrapper that cut the
              gradient would show here). The bf16 card step runs rows 5
              and 6 on the tensor cores, the f32 one on the CUDA cores.
7. resnet_kernels - BatchNorm apply (row 2) at T1's stem and widest
              BatchNorms, the bottleneck block in training (row 11) at T2's
              8 distinct block shapes and in inference (row 12) at I1's 8,
              plus one int8 inference shape, and in bf16 also row 12 at
              I1's 8 shapes and row 2 at I1's stem at B=1 (the smallest
              /predict bucket), in bf16 and f32, against their
              plain versions on the card (rtol = atol = 6e-2 in bf16, a
              bf16 block against its plain version run in f32 on the same
              inputs; 1e-4 in f32 with TF32 off; the batch statistics too),
              timed as the kernels phase times its kernels. Each block row
              names the form its call took (`variant`: every bf16 block but
              the int8 one on the tensor cores, or the row fails), its
              convolutions' TFLOP/s over its device time, and the device
              time of cuDNN's bf16 channels_last convolutions of the same
              block alone (a reference point, not the library column).
8. resnet_train - ResNet-50 (`models/resnet.py`, 1000 classes, bf16
              compute over f32 params, Nesterovs 0.9 at lr 0.1, l2 1e-4,
              seeded random weights) trained with `ComputationGraph.fit` on
              seeded learnable images (class templates plus noise, one-hot
              labels over the 1000 outputs from 10 classes): T1, the per-layer graph at 224x224, B=256
              (`bench.py:1589-1613`; halved until it fits); then T2, the
              fused-block graph at 64x64, B=32 (`bench.py:1720-1753`); 3
              warm-up and 10 timed steps each. Scores finite and falling
              (the last 3 average under the first); per step exactly 53
              BatchNorm and 1 update launch (T1, 161 tensors), or 16
              bottleneck (all 16 on the tensor-core form), 1 BatchNorm and
              1 update launch (T2); 0 plain calls.
9. resnet_infer - `ComputationGraph.output` at B=32 on 224x224 images: I1,
              the fused graph (T2's trained weights and running statistics)
              through 16 inference blocks (all on the tensor-core form) and
              1 BatchNorm per call; I2, T1's
              trained graph through 53 BatchNorms per call; 0 plain calls.
10. resnet_parity - f32, B=16, 64x64, the same seeded params on the card
              and on the CPU (plain versions), for both graphs: one `output`
              (probabilities within 1e-3), then one `fit` step (scores
              within 1e-3 relative, running statistics within rtol = atol =
              1e-3, and the Nesterovs state, lr * grad after one step,
              against a float64 CPU step's, per vertex over its largest
              |v|: the card's median and largest error no more than twice
              the CPU f32 step's, the largest allowed 4e-2 in any case; a
              cut gradient is off by about 1).
11. rnn_kernels - the LSTM cell (row 10) at the char-RNN's shapes: B=32,
              n=256 with peepholes (training), B=1 (sampling), n=200 (the
              zoo's default width), and the masked and no-peephole variants,
              in f32 (against its plain version at 1e-4, TF32 off) and bf16
              (against the plain version run in f32 on the same inputs, at
              4e-2), timed as the kernels phase times its kernels (its
              host time and bound share too); the library yardstick
              (`torch.mm` + aten `_thnn_fused_lstm_cell`) computes the step
              without peepholes or mask.
12. rnn_train - the char-RNN (`bench.py:798-840`: `char_rnn` V=77, 2
              GravesLSTM layers of 256, f32, RMSProp lr 0.1, seeded random
              weights) trained with `MultiLayerNetwork.fit` under truncated
              BPTT: B=32 sequences of 100 characters whose next character is
              a fixed permutation of the current one, chunks of 50; 3
              warm-up and 10 timed calls over 2 batches. Scores finite and
              falling; per call exactly 200 LSTM-cell and 2 update launches
              (one per chunk),
              0 plain calls, 0 launches of other kernels.
13. rnn_sample - greedy sampling with `rnn_time_step` after
              `rnn_clear_previous_state`: 200 characters from one seed
              character, then 200 steps of 32 streams; 2 cell launches per
              call; the stateful outputs equal `output` over the sampled
              sequence within 1e-4.
14. rnn_parity - f32, B=4, T=100, the same seeded params on the card and on
              the CPU (plain versions): `output` within 1e-3, one `fit`
              call's score within 1e-3 relative, and per layer RMSProp's g2
              within 4e-2 of the CPU's largest g2 (a cut gradient shows).
15. lenet_train - LeNet (`zoo.lenet_mnist`, the dl4j-examples
              LenetMnistExample: conv 5x5x20, max-pool, conv 5x5x50,
              max-pool, dense 500, softmax 10; f32, Nesterovs 0.9 at lr
              0.01, l2 5e-4, 431,080 seeded random params) as the example
              runs it: listeners set (score every 100 iterations,
              `PerformanceListener(100, sync=True)`, every score
              collected, a clock synchronizing at each iteration), one
              `fit` epoch of `MnistDataSetIterator(128)` over the 60,000
              synthetic training images (469 steps, the last of 96; each
              batch copied from the host inside `fit`), then `evaluate` on
              the 10,000 test images. Per step exactly 1 update launch (all
              8 tensors), nothing else, 0 plain calls; the listener fired at
              iterations 1..469; scores finite, the last 50 under the first
              50 on average; the confusion total 10,000 and accuracy >=
              0.95; ms/step (median after 20 steps), images/s, peak memory.
16. lenet_parity - LeNet from one seeded numpy params tree on the card and
              on the CPU (plain versions), 3 `fit` steps at B=128: per step
              scores within 1e-4 relative, params and the Nesterovs velocity
              within rtol 2e-4, atol 1e-5; `output` on 256 test images within
              1e-4; then lenet_train's trained net and a CPU net with its
              params: `evaluate` counts over the 10,000 test images equal,
              once the CPU's smallest top-1 / top-2 margin exceeds 1e-4 (a
              near-tie fails).
17. mlp_train - the MNIST MLP (`zoo.mlp_mnist`: dense 1000 relu, softmax
              10; Nesterovs 0.9 at lr 0.006, 795,010 params) as lenet_train
              runs LeNet, on flat images: 1 update launch a step (4
              tensors), 0 plain calls, accuracy >= 0.95.
18. long_kernels - the streamed flash forward (row 4) and backward (row
              7: dq, dk/dv) at the long-context slice's shape ([1, 32768,
              8, 64], causal) in bf16 and f32 against their plain versions
              on the card (4e-2 / 1e-4 as above; row 4's o also row by
              row, ||o - o_plain|| / ||o_plain|| within 1e-2 / 1e-4, and
              its lse at 1e-4; row 7's dq, dk, dv row by row over
              max(||row||, 0.1 x the median row norm) within 1.2e-2 /
              1e-4, dq from row 1, which is 0 in exact arithmetic), and at
              ragged T (12,345 f32; 24,577 bf16, one row into a new tile),
              each row with the form of its unit kernel (`variant`:
              "wgmma" for bf16 at D = 64, else "cuda_cores"), timed beside
              the plain version, the
              bound and causal SDPA (the forward; forward + backward less
              the forward), and beside the resident kernels of the same
              functions (rows 5, 6, with their form, `resident_variant`);
              each wrapper's workspace bytes. Row 13
              (`bench.py:1045 stream_sum`): row 4 over the triangular and
              the rectangular list at [1, 32768, 4, 64] bf16, o summed; the
              rectangle's o equals the triangle's within 4e-2 and row by
              row within 1e-2, its lse within 1e-4; tri_ms, rect_ms and
              their ratio.
19. long_train - the LM of phase 5 at T=32,768 (`transformer_lm(8192,
              t=32768, ...)`, ~38M params), `fit` at B=1 with Adam on the
              same learnable id rule, 2 warm-up and 5 timed steps over 2
              batches: every attention past the resident K/V limit, so per
              step exactly 4 streamed forwards, 4 dq, 4 dk/dv (all 12 on
              the tensor-core form), 9 LayerNorm and 1 update launch,
              none of rows 3, 5 and 6, 0 plain calls; scores finite and
              falling; ms/step, tokens/s, peak memory.
20. long_output - 3 `output` calls of that net at B=1, T=32,768: 4
              streamed forwards (tensor-core form) and 9 LayerNorms per
              call, 0 plain calls; probabilities finite, summing to 1,
              equal across calls.
21. long_parity - one f32 `fit` step at B=1, T=32,768 from the same seeded
              params through the streamed rows 4/7 and through the
              resident rows 5/6 (the port's `_RESIDENT_KV_LIMIT` raised for
              that step and restored): scores within 1e-4 relative, Adam's
              m per vertex within max(1e-3, twice the step's own rounding
              floor) of the resident run's largest |m| (see the phase).
22. dsl     - the config DSL and the model zip on the card. (a) T2's
              ResNet-50 (built by `graph_builder()`, trained by
              resnet_train) and lenet_train's LeNet: `save_model`, then
              `load_model(device="cuda")`; params, updater state and
              BatchNorm state bit for bit the trained net's, `output` on
              the B=32 (LeNet: 128) batch equal to the trained net's (or,
              if a kernel on the path is not deterministic, within the gap
              between two calls of the trained net, printed), then one
              further `fit` step on each: scores within 1e-6 relative;
              save and load seconds and zip bytes. (b) The multi-input
              graph of `examples/csv_graph_multi_io.py` (inputs of 4 and 3
              features, dense 16 relu on each, merged, a softmax mcxent
              and an mse head; Adam lr 0.05, seed 7) on 20 seeded
              synthetic batches of 16, on the card and on the CPU from the
              same params: scores within 1e-5 relative at every step, one
              update launch a step. (c) A graph holding all 14 vertex
              kinds at width 64 (B=32, T=16): `output` on the card within
              1e-5 of the CPU's, one `fit` step's score within 1e-5
              relative and each layer vertex's Adam m within 1e-5 of the
              CPU's largest |m| there. Launches (from 0, card windows
              only): 48 inference blocks, 32 training blocks, 5
              BatchNorms and 25 updates, 0 plain calls.
23. ckpt    - persistence and recovery on the card (build/ckpt, removed
              after). (a) The train phase's LM at full width from its seed,
              `fit` step by step over 2 batches at B=16, T=1024: twice
              uninterrupted to step 15 (the first under a
              `CheckpointManager`, async saves every 5 steps; its steps
              timed, those with a write in flight against the train phase's
              median); the two runs must be equal bit for bit. A child
              process (`chip_smoke.py --ckpt-child DIR`) trains the same
              run under a manager (`save_every` 5), a sharded
              `CheckpointListener` and a `FailureDetectionListener`, and
              is SIGKILLed while its step-10 save is being written (it
              holds that write after its first chunk). The parent
              `restore()`s the newest committed step (5; the `.tmp` is
              ignored) onto a net built on the card and trains to step 15
              as one `fit` epoch under a sharded listener and the watchdog:
              params, Adam state and scores equal the uninterrupted run's
              bit for bit. Then one param times NaN and 2 steps: the
              watchdog rolls back once, in place, to step 15 (the state
              equal to the uninterrupted run's), and 2 more steps have
              finite scores and move the restored params. Snapshot ms on
              the training thread, write s, checkpoint bytes, restore s.
              (b) T2 (resnet_train's fused graph, B=32, 64x64) from its seed
              for 8 steps as one `fit` epoch under a zip
              `CheckpointListener` every 4 steps; twice, equal bit for bit;
              `load_checkpoint` of the step-4 zip plus 4 steps equals the
              uninterrupted run, BatchNorm running statistics included;
              snapshot ms and write s beside the dsl phase's measured
              12.4-14.0 s synchronous `save_model`. (c) LeNet under
              `EarlyStoppingTrainer` for 2 epochs of `MnistDataSetIterator
              (128)`, scored by `DataSetLossCalculator` on the test set,
              the best model saved by `LocalFileModelSaver` in both formats:
              each reloads on the card with `output` equal bit for bit to
              the saved net's. Launches (card windows only): per LM step 9
              LayerNorm, 4 each of rows 5 and 6's three kernels, 1 update;
              per T2 step 16 blocks, 1 BatchNorm, 1 update; per LeNet step
              1 update; 0 plain calls.
24. serving - the serving tier on the card, from disk (build/serving,
              removed after). (a) The serving LM (phase 3's seeded weights,
              the output projection times SERVE_LOGIT_SCALE so that greedy
              decoding has margins to compare) saved as a
              `CheckpointManager` root, I1 (resnet_train's T2 weights at
              224) as a sharded checkpoint and lenet_train's LeNet as a
              zip; `InferenceServer.from_checkpoint(..., warmup=True,
              kv_cache="paged", draft=<a twin of the LM>, spec_k=4)` plus
              `add_model("resnet", path=...)` and `add_model("lenet",
              path=...)`: during warmup `/healthz` reads "warming" and
              `/predict` answers 503 with Retry-After; warmup's launches
              exactly its work (every batch bucket of each model, every
              prompt bucket of the LM and its draft, one step, the 4
              verify widths). (b) `/predict` to ResNet-50 with 1, 3, 8,
              17, 32 and 40 rows (1 and 3 over HTTP) and to LeNet with 1
              and 128 (over HTTP), each response row by row against
              `output` of the same rows at B=32 (6e-2 bf16, 1e-4 f32), 16
              row-12 and 1 row-2 launches a ResNet batch, then a second,
              warm call in process, timed. (c) Eight greedy and two
              sampled (0.8, top_k 40, seeded) `/generate` at once, the
              300-token prompt twice (a prefix-cache hit), while ResNet-50
              answers the (b) sizes in process (its batcher's thread and
              the decode thread launching on one card at once; each
              response against `output` again); launches exactly the work
              (target and draft prefills, verifies with 5 query rows,
              draft steps, 16 + 1 a ResNet batch; row 3 on the tensor
              cores); greedy ids against a non-speculative scheduler on the
              same net, token for token up to the first position where
              its top-two probabilities lie within 4e-2; accepted
              speculative tokens > 0. (d) The same traffic to a
              drain-mode model over the same net: ids equal. (e) One
              scrape: every ported family, `dl4j_requests_total` moved by
              exactly the requests sent, `?format=json&names=` narrowed;
              TTFT, the speculative round's time, the inter-token gap and
              the acceptance rate. 0 plain calls, no training kernel. The
              phase's wall seconds (`phase_s`).
25. long_serve - the LM at T = 32,768 (`decode_cache_length=32768`,
              the output projection times SERVE_LOGIT_SCALE) behind a
              paged server, 4 slots: one prompt of 30,000 seeded ids, 16
              greedy tokens. The prefill pads to the 32,768 bucket: 4
              row-4 launches, no row 3; each decode step 4 row-8 launches
              at cursors past 30,000; TTFT, the step's ms and the peak
              memory. Then the first-token distribution and 4 decode
              steps through the kernels against the same weights through
              the plain versions on the card (`plain_versions()`):
              probabilities at 4e-2, and logits (centered log-probs)
              within LONG_LOGIT_TOL of their norm; the same logit check
              must fail with a planted fault, the first block's attention
              zeroed in row 4 (the first distribution) or in row 8 (the
              4 steps). The phase's wall seconds (`phase_s`).
26. layers  - the rest of the layers. (a) AlexNet (`zoo.alexnet`: conv
              11x11/4 + LRN + pool, conv 5x5 + LRN + pool, three 3x3
              convs, pool, dense 4096 x2 with dropout 0.5 (retain),
              softmax; 1000 classes at 224, bf16 compute, Nesterovs 0.9 at
              lr 0.01, l2 5e-4, seeded random weights) trained with
              `MultiLayerNetwork.fit` at B=128 on rn_batches' learnable
              images, 3 warm-up and 10 timed steps: scores finite and
              falling (the last 3 average under the first), per step
              exactly 1 update launch (16 tensors), 0 plain calls; ms a
              step, images/s, peak memory. After step 5 a
              `CheckpointManager` save, the key and a train-mode `output`
              of 16 images (outside the walls). (b) `output` at B=128:
              inference twice bit for bit equal, train-mode different, no
              launch. (c) Dropout at AlexNet's two dense inputs, [128,
              6400] and [128, 4096], retain 0.5, from the engine's next
              subkey: kept share within 0.5 +- 0.005, kept values exactly
              2, the same key the same mask, the next step's key another,
              the two layers' masks uncorrelated (|r| <= 0.01), the masks
              on the card. (d) LRN at [128,54,54,96] and [128,26,26,256]
              against the same function on the CPU (f32, 1e-4); its bf16
              time. (e) AlexNet f32 at B=4 from the same params on the
              card and on the CPU: `output` within 1e-3; one `fit` step
              with the same keep masks on both sides and on a float64
              CPU step (the draw function swapped for one that draws on
              the CPU and moves the mask): scores within 1e-3 relative,
              the Nesterovs v held to the f64 step as resnet_parity holds
              it. (f) The net restored from the step-5 checkpoint: its
              key equal to the saved one, its train-mode `output` of the
              same 16 images equal bit for bit. (g) VGG-16
              (`zoo.vgg16`, 1000 classes, bf16, Nesterovs 0.9 at lr 0.01,
              relu init): `output` at B=32 (finite probabilities), then
              `fit` at B=128, 3 + 10 steps, 1 update launch a step (32
              tensors); the first score finite, the rest reported (from
              this random init at this lr the reference diverges too);
              f32 `output` at B=2 card against CPU within 1e-3. The
              phase's wall seconds (`phase_s`).
27. masked  - features masks. `zoo.transformer_classifier` at the LM's
              widths (V=8192, d=512, 8 heads, 4 blocks, 8 classes, bf16,
              Adam at the zoo's lr) on B=16 ragged sequences of 128-1024
              int64 ids padded to 1024 (about half of each sequence its
              class's marker id), int32 labels and a features mask, 3
              warm-up and 20 timed steps: scores finite and falling; per
              step exactly 9 LayerNorm and 1 update launch and no flash
              row (a masked batch runs the dense masked attention, as the
              reference routes it), 0 plain calls; ms a step, sequences
              and real tokens a second, peak memory. Then an unmasked
              step at T=1024 (after one that warms its path): 4 launches
              each of rows 5, 6 dq and 6 dk/dv, non-causal, all on the
              tensor cores. Padded ids changed leave the masked `output`
              equal bit for bit; `evaluate` under the mask gives an
              accuracy; f32 masked `output` at B=2, T=256 card against
              CPU within 1e-3. The phase's wall seconds.
28. moe     - `zoo.transformer_lm(moe=True)` at the LM's widths (V=8192,
              T=1024, d=512, 8 heads, 4 blocks, each FFN a top-2 MoE of 4
              experts of 2,048, router jitter 1e-2, bf16 compute over f32
              params, Adam lr 3e-3) trained at B=16 on lm_batches, 3
              warm-up and 10 timed steps: scores finite and falling; per
              step exactly the dense LM's launches (9 LayerNorm, 4 each of
              rows 5, 6 dq, 6 dk/dv on the tensor cores, 1 update), 0
              plain calls; ms a step, tokens/s, peak memory. `output` on
              one batch (9 LayerNorm, 4 row 3; wall and the forward alone)
              with each layer's routing: aux loss, kept load per expert,
              first choices, dropped share. 16 cached greedy tokens after
              a 40-id prompt from the decode-cache twin of the trained
              params (output projection x SERVE_LOGIT_SCALE), equal to the
              CPU's ids (9 LayerNorm a call, 4 row 3 for the prompt). The
              MoE layer that dropped the most, alone, on the tokens it got
              in `output`, card against CPU (one jitter draw shared):
              routing identical, y, aux, gates and gradients within
              MOE_GRAD_TOL of their largest value, less the w1 / b1
              columns and x rows downstream of a ReLU kink the two
              devices' f32 sums put on either side of 0 (counted, at most
              MOE_FLIP_SHARE); its forward + backward and its six f32
              expert matmuls timed. One f32 step at 1 block, B=2, card
              against CPU with the draws shared: scores within 1e-3, Adam
              state within 4e-2, at most MOE_FLIP_SHARE of the params a
              step apart. The phase's wall seconds.
29. pretrain - f32 on MnistDataSetIterator(128), one epoch each: the VAE
              (pretrain only), the AutoEncoder + RBM + output stack
              (pretrained, then backprop), LeNet with a
              CenterLossOutputLayer, an MLP ending in a LossLayer. Each
              net's first `fit` call card against CPU with the draws made
              on the CPU (scores and every updater and declared state
              tensor within 1e-3); then the epoch on the card: exactly one
              update launch a step (pretraining steps included), 0 plain
              calls, every pass's objective falling (the last 50 steps'
              mean under the first 50's; an RBM's CD-k surrogate only
              reported), accuracy on the 10,000 test images (LeNet's >=
              0.95), the centers moved; ms a step, peak memory. The
              phase's wall seconds.
30. trace   - where one decode step's, one 1024-token prefill's, one LM
              training step's, one T1 and one T2 step's, one char-RNN fit
              call's (forward, backward, update; the call's two chunks
              summed), one `rnn_time_step`'s, one LeNet and one MLP fit
              call's at B=128 (whole, and by part) and one long-context
              training step's time goes: host wall time, kernel time on
              the card (torch.profiler), the card's idle share and the top
              kernels;
              and, in one traced window after a long-context step, causal
              SDPA at row 4's shape beside row 4 (device ms per call);
              every row 3, 5 and 6 launch there on the tensor-core form;
              each traced step's update part runs no `sub`, `add` or `mul`
              op on the host (no pass over deltas; its one launch per
              update is held by the phases' launch counts).

Then the card line, the `{"kernels": [...]}` line (each kernel with its
launches on each main path: serve, LM train, T1, T2, I1, I2, rnn_train,
rnn_sample, lenet_train, mlp_train, dsl, ckpt, serving, long_serve,
long_train, long_output, alexnet_train, vgg16_train, masked_train,
unmasked_step, moe_train, moe_output, moe_decode, pretrain_vae,
pretrain_ae_rbm, pretrain_lenet_center_loss, pretrain_mlp_loss_layer;
row 8's, row 12's and row 2's serving shapes under
`serving_shapes`; rows 5 and 6 non-causal under `non_causal_shapes`;
row 13 on row 4's entry; row 9 also with its time at LeNet's update) and,
last, the result line. With no GPU, without the package beside it, or when
any phase fails, it exits non-zero and prints no result.
"""

import contextlib
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

PEAK_BYTES_S = 3.35e12                      # H100 SXM HBM3
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16; f32 w/o TF32
TOL = {"bfloat16": 4e-2, "float32": 1e-4}
# Copies of the input that row 1's timed calls at the LM step's shape
# take in turn, so that none is still in the L2 (50 MB) at its next read.
L2_COPIES = 8

VOCAB, D_MODEL, HEADS, BLOCKS, CACHE = 8192, 512, 8, 4, 1024
SLOTS, PAGE = 4, 64
ROOT = "deeplearning4j_tpu_torch/kernels/csrc/"
TRAIN_B, WARMUP, TIMED = 16, 3, 20
FA = "deeplearning4j_tpu/kernels/flash_attention.py:"
BB = "deeplearning4j_tpu/kernels/bottleneck_block.py:"
# Each kernel's C entry and the TPU kernel it replaces. The bf16 forms of
# rows 3, 5 and 6 at D = 64 / 128 are the tile kernels of
# TENSOR_CORE_SOURCE over their rows schedule, reached from those entries
# (the kernels line names that file too).
TENSOR_CORE_SOURCE = ROOT + "flash_attention_stream.cu"
KERNEL_INFO = {
    "layernorm_norm_act": (ROOT + "norm_act.cu",
                           "deeplearning4j_tpu/kernels/norm_act.py:101"),
    "flash_attention": (ROOT + "flash_attention.cu", FA + "99"),
    "paged_decode_attention": (ROOT + "paged_attention.cu", FA + "733"),
    "flash_attention_fwd_lse": (ROOT + "flash_attention.cu", FA + "376"),
    "flash_attention_bwd_dq": (ROOT + "flash_attention_bwd.cu", FA + "386"),
    "flash_attention_bwd_dkv": (ROOT + "flash_attention_bwd.cu", FA + "426"),
    "fused_update": (ROOT + "fused_update.cu",
                     "deeplearning4j_tpu/kernels/fused_update.py:109"),
    "batchnorm_norm_act": (ROOT + "norm_act.cu",
                           "deeplearning4j_tpu/kernels/norm_act.py:96"),
    "bottleneck_train": (ROOT + "bottleneck_block.cu", BB + "229"),
    "bottleneck_infer": (ROOT + "bottleneck_block.cu", BB + "261"),
    "lstm_cell": (ROOT + "lstm_cell.cu",
                  "deeplearning4j_tpu/kernels/lstm_cell.py:119"),
    "flash_attention_stream": (ROOT + "flash_attention_stream.cu", FA + "137"),
    "flash_attention_bwd_dq_stream": (ROOT + "flash_attention_stream.cu",
                                      FA + "551"),
    "flash_attention_bwd_dkv_stream": (ROOT + "flash_attention_stream.cu",
                                       FA + "595"),
}
SERVING_KERNELS = ("layernorm_norm_act", "flash_attention",
                   "paged_decode_attention")
# Launches per training step of the smoke model: 2 LayerNorms per block and
# the final one; one attention per block; one update for all 24 layer
# vertices' 66 tensors (the kernel's table holds 256).
TRAIN_LAUNCHES = {"layernorm_norm_act": 2 * BLOCKS + 1,
                  "flash_attention_fwd_lse": BLOCKS,
                  "flash_attention_bwd_dq": BLOCKS,
                  "flash_attention_bwd_dkv": BLOCKS,
                  "fused_update": 1}
TRAIN_FLASH = ("flash_attention_fwd_lse", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")

# ResNet-50: the paths T1, T2 (training) and I1, I2 (inference).
RN_TOL = {"bfloat16": 6e-2, "float32": 1e-4}
RN_CLASSES, RN_WARMUP, RN_TIMED, INFER_B = 1000, 3, 10, 32
RN_LEARN_CLASSES = 10   # the classes the training batches draw from
RN_PARITY_B = 16        # see phase_resnet_parity
RN_PATHS = {  # image, fused blocks, batch
    "t1": (224, False, 256), "t2": (64, True, 32),
    "i1": (224, True, INFER_B), "i2": (224, False, INFER_B)}
# Launches per training step or per output call: one BatchNorm per
# BatchNormalization layer (53 unfused, the stem's when fused), one block
# per BottleneckBlock (16), one update for every param tensor of the step
# (161 in both graphs).
RN_LAUNCHES = {
    "t1": {"batchnorm_norm_act": 53, "fused_update": 1},
    "t2": {"bottleneck_train": 16, "batchnorm_norm_act": 1,
           "fused_update": 1},
    "i1": {"bottleneck_infer": 16, "batchnorm_norm_act": 1},
    "i2": {"batchnorm_norm_act": 53}}
# The stages of ResNet-50: (filters, blocks, first stride).
RN_STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
# The fused paths' block rows, every launch of which takes the tensor-core
# form (bf16, widths that are multiples of 64).
RN_BLOCK_FORMS = {"t2": ("bottleneck_train",), "i1": ("bottleneck_infer",)}

# The char-RNN (`bench.py:798-840` char_rnn_fused_lstm): 2 GravesLSTM layers
# of 256 over 77 characters, f32, RMSProp; B=32 sequences of 100 in tBPTT
# chunks of 50. Per fit call: one cell per layer and step, one update (all
# 3 layers) per chunk.
RNN_V, RNN_H, RNN_LAYERS, RNN_B, RNN_T, RNN_CHUNK = 77, 256, 2, 32, 100, 50
RNN_WARMUP, RNN_TIMED, RNN_SAMPLE, RNN_PARITY_B = 3, 10, 200, 4
RNN_LAUNCHES = {"lstm_cell": RNN_LAYERS * RNN_T,
                "fused_update": RNN_T // RNN_CHUNK}

# LeNet and the MNIST MLP (`deeplearning4j_tpu/models/zoo.py:32-61`; the
# dl4j-examples LenetMnistExample and MLPMnistSingleLayerExample): f32,
# Nesterovs 0.9, B=128, one `fit` epoch over the 60,000 synthetic training
# images (469 steps, the last of 96), then `evaluate` on the 10,000 test
# images. Per step one update launch for all the layers' tensors (LeNet 8,
# the MLP 4).
MNIST_B, MNIST_WARMUP, MNIST_TRAIN_N, MNIST_TEST_N = 128, 20, 60000, 10000
MNIST_STEPS = -(-MNIST_TRAIN_N // MNIST_B)
MNIST_LAUNCHES = {"fused_update": 1}
MNIST_ACCURACY = 0.95
LENET_PARITY_STEPS, LENET_PARITY_EVAL = 3, 256
LENET_PARAM_TOL = dict(rtol=2e-4, atol=1e-5)
NEAR_TIE = 1e-4

# The config DSL and the model zip (the dsl phase): zips under the
# checkout's build directory; the multi-input graph's 20 steps of 16; the
# all-vertex graph at width 64, B=32, T=16. Launches per card window.
DSL_DIR = os.path.join("build", "dsl")
DSL_MULTI_STEPS, DSL_MULTI_B, DSL_SCORE_TOL = 20, 16, 1e-5
DSL_WIDTH, DSL_B, DSL_T, DSL_CLASSES = 64, 32, 16, 10
DSL_REFIT_TOL = 1e-6
DSL_LAUNCHES = {
    # 3 `output` calls (16 blocks + the stem's BatchNorm each) and 2 fit
    # steps (16 blocks, 1 BatchNorm, 1 update each).
    "t2": {"bottleneck_infer": 48, "bottleneck_train": 32,
           "batchnorm_norm_act": 5, "fused_update": 2},
    "lenet": {"fused_update": 2},
    "multi_io": {"fused_update": DSL_MULTI_STEPS},
    "vertices": {"fused_update": 1}}

# Persistence and recovery (the ckpt phase), under the checkout's build
# directory. LM: checkpoints every 5 steps; the child is killed while its
# second save (step 10) is being written; the parent resumes from step 5
# to step 15, then poisons a param and runs 2 steps (the watchdog rolls
# back once) and 2 more. T2: a zip every 4 steps, 8 steps, resumed from
# step 4. M1: early stopping over 2 epochs. Launches per card window.
CKPT_DIR = os.path.join("build", "ckpt")
CKPT_EVERY, CKPT_KILL, CKPT_STEPS, CKPT_POISONED = 5, 10, 15, 2
CKPT_CHILD_FLAG = "--ckpt-child"
CKPT_CHILD_TIMEOUT_S = 300
CKPT_T2_EVERY, CKPT_T2_STEPS = 4, 8
CKPT_ES_EPOCHS = 2
# T2's synchronous `save_model` on the training thread as the dsl phase
# measured it (H100 80GB HBM3, 700 W), set beside this phase's off-thread
# zip write.
CKPT_T2_SYNC_SAVE_S = (12.4, 14.0)

# The rest of the layers (the layers phase): AlexNet (`zoo.alexnet`) and
# VGG-16 (`zoo.vgg16`) at 224, 1000 classes, bf16 compute over f32 params,
# Nesterovs; B=128 (`bench.py:946`'s batch), 3 warm-up and 10 timed steps
# each on rn_batches' learnable images. Per step one update launch for all
# the layers' tensors (AlexNet 16, VGG-16 32); dropout, LRN, the
# convolutions (cuDNN) and the pools have no kernel of the port (the JAX
# package has no Pallas kernel for them).
LAYERS_B, LAYERS_IMAGE = 128, 224
LAYERS_LAUNCHES = {"fused_update": 1}
ALEX_DENSE = (10, 11)                  # AlexNet's two dense layers (dropout)
ALEX_DROP_SHAPES = ((LAYERS_B, 6400), (LAYERS_B, 4096))  # their inputs
ALEX_LRN_SHAPES = ((LAYERS_B, 54, 54, 96), (LAYERS_B, 26, 26, 256))
KEEP_TOL, CORR_TOL = 0.005, 0.01
ALEX_PARITY_B, VGG_PARITY_B, VGG_OUTPUT_B, PARITY_TOL = 4, 2, 32, 1e-3
ALEX_SAVE_STEP, ALEX_PROBE_B = 5, 16
LAYERS_DIR = os.path.join("build", "layers")

# Features masks (the masked phase): `zoo.transformer_classifier` at the
# LM's widths (V=8192, d=512, 8 heads, 4 blocks; `bench.py:1116`), 8
# classes, bf16, Adam at the zoo's lr; B=16 ragged sequences of 128-1024
# ids padded to T=1024 under a features mask; 3 warm-up and 20 timed
# steps. A masked step runs the dense masked attention (plain PyTorch, as
# the reference routes a masked batch to XLA): 9 LayerNorms and 1 update,
# no flash row. One unmasked step adds rows 5 and 6 non-causal, 4 each.
MASK_CLASSES, MASK_MIN_T = 8, 128
MASK_LAUNCHES = {"layernorm_norm_act": 2 * BLOCKS + 1, "fused_update": 1}
MASK_PARITY_B, MASK_PARITY_T = 2, 256

# The MoE LM (the moe phase): `transformer_lm(moe=True)` at the LM cell's
# widths (V=8192, T=1024, d=512, 8 heads, 4 blocks; `bench.py:1116`), 4
# experts of 4 * d = 2,048, top-2, router jitter 1e-2 (the zoo's), bf16
# compute over f32 params, Adam lr 3e-3; B=16, 3 warm-up and 10 timed
# steps on lm_batches. A step launches what the dense LM's does (rows 1,
# 5, 6, 9); the router and the f32 expert FFN are plain PyTorch, as the
# reference computes them outside Pallas. `output` on one batch: rows 1
# and 3. Cached greedy decode of MOE_NEW tokens after a MOE_PROMPT-token
# prompt: row 3 for the prompt, row 1 at every call.
MOE_EXPERTS, MOE_TIMED, MOE_PROMPT, MOE_NEW, MOE_PARITY_B = 4, 10, 40, 16, 2
MOE_LAUNCHES = {"layernorm_norm_act": 2 * BLOCKS + 1, "fused_update": 1,
                **{n: BLOCKS for n in TRAIN_FLASH}}
MOE_OUTPUT_LAUNCHES = {"layernorm_norm_act": 2 * BLOCKS + 1,
                       "flash_attention": BLOCKS}
MOE_DECODE_LAUNCHES = {"layernorm_norm_act": (2 * BLOCKS + 1) * MOE_NEW,
                       "flash_attention": BLOCKS}
MOE_GRAD_TOL = 1e-4     # the MoE layer card vs CPU, over the largest value
MOE_FLIP_SHARE = 1e-3   # params a first normalised step may send the
                        # other way (a gradient that is rounding noise)

# Layerwise pretraining and the last layers (the pretrain phase), f32 on
# the synthetic MNIST at B=128, one epoch each: the VAE of dl4j-examples'
# VariationalAutoEncoderExample (784 -> 256, 256 -> 2 -> 256, 256,
# Bernoulli, leaky relu, RMSProp decay 0.95, l2 1e-4, pretrain only) at lr
# PRETRAIN_VAE_LR, not the example's 1e-2: there the reference's own VAE
# reaches a NaN ELBO at its second step on this data (RMSProp's first
# step is lr * g / sqrt(0.05 g^2), about 4.5 lr on every param), and the
# port's the same from the same params;
# 784-500-250-10 (an AutoEncoder at corruption 0.3, an RBM at k=1, an
# OutputLayer; Adam, pretrained then backprop); LeNet with a
# CenterLossOutputLayer (alpha 0.1, lambda 2e-4); an MLP ending in a
# LossLayer (Adam). One update launch (row 9) a step, pretraining steps
# included.
PRETRAIN_VAE_LR, PRETRAIN_STACK_LR = 1e-3, 1e-3

# Long context: the same LM at T = 32,768, B = 1, where the K/V of
# one (batch, head) outgrow the resident limit and every attention takes the
# streamed rows 4 and 7. Row 13 (`bench.py:1033`) runs row 4 over the
# triangular and the rectangular list at B*H = 4.
LONG_T, LONG_B, LONG_WARMUP, LONG_TIMED = 32768, 1, 2, 5
RAGGED_T = 12345            # over the f32 limit, no multiple of 64
RAGGED_BF16_T = 24577       # over the bf16 limit, one row into a new tile
ROW13_HEADS = 4
LSE_TOL = 1e-4
# Row 4's o is also held row by row: the largest, over the (b, t, h) rows,
# of ||o - o_plain|| / ||o_plain||. At T = 32,768 a row's |o| is about
# sqrt(e / t), 0.01-0.03 past row 4,096, so rtol = atol = 4e-2 alone would
# let a fault of several percent of a row pass. bf16's limit is about
# twice the largest such error its rounding gives (PERF.md §6).
ROW_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# Row 7's dq, dk and dv are held row by row too, each row's error over
# max(||w_row||, ROW_FLOOR x the median row norm). The causal dq row 0 (one
# key: ds = p (dp - D) with D = dp) is 0 in exact arithmetic and rounding
# noise in f32 (~6e-6 in the plain version itself against a float64 run,
# on an H100): it is held elementwise only. bf16's limit is about twice the
# largest error its rounding of p and ds to bf16 gives (PERF.md §6).
BWD_ROW_TOL = {"bfloat16": 1.2e-2, "float32": 1e-4}
ROW_FLOOR = 0.1
# The streamed rows 4 and 7 by their unit kernels (`stream_<unit>_kernel`,
# `stream_<unit>_wgmma_kernel`), whose forms `variant_launches` counts.
STREAM_UNITS = {"flash_attention_stream": "fwd",
                "flash_attention_bwd_dq_stream": "dq",
                "flash_attention_bwd_dkv_stream": "dkv"}
# The resident rows 3, 5 and 6, whose bf16 form at D = 64 is the same
# tensor-core kernels over one block per whole row (or column) of tiles
# (`stream_<unit>_wgmma_kernel<64, rows>`); `variant_launches` counts their
# forms too.
RESIDENT_ROWS = ("flash_attention", "flash_attention_fwd_lse",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
LONG_REPS = dict(reps=3, warmup=1)
# The serving tier (the serving and long_serve phases): the serving LM
# behind a paged server with a twin draft proposing SPEC_K tokens a round
# (a verify feeds SPEC_K + 1 query rows to row 8, whose limit is 8),
# ResNet-50's I1 graph and LeNet behind /predict (batch buckets 1-32),
# all three read from disk under the checkout's build directory. Greedy
# speculative ids are held to a non-speculative run up to its first
# near-tie: top-two probabilities within SPEC_TIE. The long server holds
# the LM at T = 32,768 and answers one 30,000-token prompt.
SPEC_K, SPEC_TIE = 4, 4e-2
# The serving LM's output projection is its seeded weights times this,
# so that its next-token distribution has margins a greedy comparison can
# read (unscaled, a random LM over 8,192 ids is near uniform: every
# top-two gap is ~1e-5).
SERVE_LOGIT_SCALE = 10.0
SERVE_DIR = os.path.join("build", "serving")
SERVE_RN_ROWS = (1, 3, 8, 17, 32, 40)
SERVE_RN_HTTP_ROWS = (1, 3)
SERVE_LENET_ROWS = (1, 128)
SERVE_TIMEOUT_S = 600
# (prompt length, new tokens): the 300-token prompt twice (a prefix-cache
# hit; the first is sent alone until it is prefilled). Every request ends
# more than SPEC_K tokens short of the 1,024-token cache, so every verify
# feeds SPEC_K + 1 rows whatever else is in flight (the clamp near the
# capacity is held on the CPU).
SERVE_GREEDY = ((40, 16), (300, 20), (700, 24), (990, 24), (41, 18),
                (301, 16), (701, 20), (300, 20))
SERVE_SAMPLED = ((45, 18, 11), (200, 16, 12))  # (length, new tokens, seed)
LONG_POS = [29990, 30000, 30008, 30016]
LONG_PROMPT, LONG_NEW, LONG_PARITY_STEPS = 30000, 16, 4
# The long server's kernel run against its plain run: each distribution's
# centered log-probabilities (its logits) within LONG_LOGIT_TOL of their
# norm. A planted fault (the first block's attention zeroed) must exceed
# it; PERF.md §6 has the readings it was set from.
LONG_LOGIT_TOL = 0.1
LONG_LAUNCHES = {"layernorm_norm_act": 2 * BLOCKS + 1,
                 "flash_attention_stream": BLOCKS,
                 "flash_attention_bwd_dq_stream": BLOCKS,
                 "flash_attention_bwd_dkv_stream": BLOCKS,
                 "fused_update": 1}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def emit(card, **obj):
    print(json.dumps({**obj, "card": card}), flush=True)


def time_ms(fn, reps=25, warmup=5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, calls=50) -> float:
    """Host time per call of `fn` over `calls` back-to-back calls, the card
    left to run behind them (warmed up, synchronized after): what a
    wrapper's Python and launch cost the caller's thread."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def device_kernels(torch, fn, reps):
    """Kernel executions on the card while `fn` runs `reps` times, from
    torch.profiler (CUPTI): [(name, start_us, end_us)], or None when the
    profiler reports no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return out or None


def device_ms(torch, fn, reps=20):
    """Summed kernel time on the card per call of `fn` (no launch gaps)."""
    ev = device_kernels(torch, fn, reps)
    return None if ev is None else sum(e - s for _, s, e in ev) / reps / 1e3


def compare(got, want, dtype, tols=TOL):
    """Max abs error and whether every element is within rtol = atol =
    tols[dtype]; `got`/`want` are tensors or equal-length sequences."""
    if isinstance(got, (tuple, list)):
        res = [compare(g, w, dtype, tols) for g, w in zip(got, want)]
        return max(e for e, _ in res), all(ok for _, ok in res)
    diff = (got.float() - want.float()).abs()
    tol = tols[dtype]
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return float(diff.max()), ok


def compare_rows(got, want, dtype, tols=ROW_TOL, floor=None):
    """The largest relative error of a row ([..., D]), ||got - want|| over
    ||want|| (or over floor x the median ||want|| where that is larger),
    and whether it is within tols[dtype]."""
    g, w = got.float(), want.float()
    norm = w.norm(dim=-1)
    if floor is not None:
        norm = norm.clamp(min=floor * float(norm.median()))
    err = float(((g - w).norm(dim=-1) / norm).max())
    return err, err <= tols[dtype]


def tensor_core_ptxas(ptxas):
    """The tensor-core kernels' ptxas lines by readable name:
    `stream_<unit>_wgmma_kernel<D, list>` (rows 4 and 7) or `<D, rows>`
    (rows 3, 5 and 6), from `_build.last_build["ptxas"]` (mangled names)."""
    out = {}
    for name, lines in ptxas.items():
        m = re.search(r"(stream_[a-z]+_wgmma_kernel)ILi(\d+)ELb([01])E", name)
        if m:
            sched = "rows" if m.group(3) == "1" else "list"
            out[f"{m.group(1)}<{m.group(2)}, {sched}>"] = lines
    return out


def bound_share(bound_ms, dev_ms):
    """The bound over the measured device time (1 = at the bound)."""
    return None if not dev_ms else bound_ms / dev_ms


def bound(nbytes, ops, dtype):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _launch_errors(counts, per_call, calls):
    """Errors unless `counts` (from 0) hold exactly `calls` x `per_call`
    launches, 0 of every other kernel, and no plain-version call; and the
    launches expected."""
    want = {name: 0 for name in KERNEL_INFO}
    want.update({k: v * calls for k, v in per_call.items()})
    errors = []
    if counts["launches"] != want:
        errors.append(f"launches {counts['launches']} != expected {want}")
    if any(counts["plain_calls"].values()):
        errors.append(f"plain versions ran on the card: "
                      f"{counts['plain_calls']}")
    return errors, want


def kernel_cases(torch, dev, dtype_name):
    """(name, shape label, kernel fn, plain fn, library fn or None, bytes,
    ops) at the serving path's shapes."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import norm_act

    dt = getattr(torch, dtype_name)
    es = torch.tensor([], dtype=dt).element_size()
    rng = np.random.RandomState(0)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.tensor(rng.randn(*shape) * scale + shift, dtype=dt,
                            device=dev)

    cases = []
    # A decode step's 4 slots; the widest prefill; an LM training step's
    # B * T = 16,384 rows. There x and the output (33.6 MB in bf16) would
    # stay in the card's 50 MB L2 from one timed call to the next, where the
    # step reads x from HBM: so each call takes the next of L2_COPIES
    # copies of x (the kernel, its plain version and the library alike),
    # 134 MB of inputs between two reads of one copy.
    for rows in (4, 1024, TRAIN_B * CACHE):
        x = t(rows, D_MODEL, scale=2.0, shift=0.5)
        xs = [x] + [x.clone() for _ in range(
            L2_COPIES - 1 if rows == TRAIN_B * CACHE else 0)]
        g, b = t(D_MODEL, scale=0.3, shift=1.0), t(D_MODEL)
        label = f"[{rows},{D_MODEL}]" + (
            f", {len(xs)} copies of x in turn" if len(xs) > 1 else "")
        cases.append((
            "layernorm_norm_act", label,
            lambda c=itertools.cycle(xs), g=g, b=b:
                norm_act.layernorm_norm_act(next(c), g, b, 1e-5, "identity"),
            lambda c=itertools.cycle(xs), g=g, b=b: norm_act.layernorm_plain(
                next(c), g, b, 1e-5, "identity"),
            lambda c=itertools.cycle(xs), g=g, b=b: F.layer_norm(
                next(c), (D_MODEL,), g, b, 1e-5),
            (2 * rows * D_MODEL + 2 * D_MODEL) * es, 8 * rows * D_MODEL))

    T, dh = CACHE, D_MODEL // HEADS
    q, k, v = (t(1, T, HEADS, dh) for _ in range(3))
    qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    cases.append((
        "flash_attention", f"[1,{T},{HEADS},{dh}] causal",
        lambda: fa.flash_attention(q, k, v, causal=True),
        lambda: fa.dense_attention(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
        4 * T * HEADS * dh * es, 4 * dh * HEADS * T * (T + 1) // 2))

    n_pages, pool = CACHE // PAGE, SLOTS * (CACHE // PAGE) + 1
    kp, vp = t(pool, PAGE, HEADS, dh), t(pool, PAGE, HEADS, dh)
    qd = t(SLOTS, 1, HEADS, dh)
    # Slots mid-generation, then every slot at the end of its cache (8.4
    # MB of K and V in bf16). Beside the second, a reference point that is
    # not the library column (it omits the gather): SDPA over the same
    # keys gathered into a dense [slots, heads, 1024, 64] cache beforehand,
    # every key visible to the decode query as the causal limit gives.
    for pos in (np.asarray([1000, 700, 330, 40], np.int32),
                np.full(SLOTS, CACHE - 1, np.int32)):
        perm = rng.permutation(np.arange(1, pool))
        table = np.zeros((SLOTS, n_pages), np.int32)
        for s in range(SLOTS):
            n = -(-(int(pos[s]) + 1) // PAGE)
            table[s, :n] = perm[s * n_pages: s * n_pages + n]
        table_t = torch.tensor(table, device=dev)
        pos_t = torch.tensor(pos, device=dev)
        keys = int(np.minimum(pos + 1, n_pages * PAGE).sum())
        ref = ()
        if (pos == CACHE - 1).all():
            idx = table_t.long()
            kc, vc = (a[idx].reshape(SLOTS, CACHE, HEADS, dh)
                      .transpose(1, 2).contiguous() for a in (kp, vp))
            qc = qd.transpose(1, 2).contiguous()
            ref = (("F.scaled_dot_product_attention over the pre-gathered "
                    f"dense cache [{SLOTS},{HEADS},{CACHE},{dh}], no mask "
                    "(every key visible), the gather not counted",
                    lambda qc=qc, kc=kc, vc=vc:
                        F.scaled_dot_product_attention(qc, kc, vc)),)
        cases.append((
            "paged_decode_attention",
            f"q[{SLOTS},1,{HEADS},{dh}] pool[{pool},{PAGE},{HEADS},{dh}] "
            f"pos={pos.tolist()}",
            lambda table_t=table_t, pos_t=pos_t:
                fa.paged_decode_attention(qd, kp, vp, table_t, pos_t, True),
            lambda table_t=table_t, pos_t=pos_t:
                fa.paged_gather_dense(qd, kp, vp, table_t, pos_t, True),
            None,
            2 * keys * HEADS * dh * es + 2 * SLOTS * HEADS * dh * es
            + table.nbytes + pos.nbytes,
            4 * dh * HEADS * keys, *ref))
    # The speculative verify (q of SPEC_K + 1 rows at the mid-generation
    # cursors) and the long server's cache (512 pages a slot, cursors past
    # 29,000) by 1 and SPEC_K + 1 query rows.
    for t, n_pg, pos in ((SPEC_K + 1, n_pages, [1000, 700, 330, 40]),
                         (1, LONG_T // PAGE, LONG_POS),
                         (SPEC_K + 1, LONG_T // PAGE, LONG_POS)):
        cases.append(paged_case(torch, dev, dt, t, n_pg, pos,
                                seed=t * 1000 + n_pg))
    return cases


def paged_case(torch, dev, dt, t, n_pages, pos, seed):
    """Row 8 at q [SLOTS, t, HEADS, 64] over a pool of SLOTS x n_pages + 1
    pages (drawn on the card), each slot's pages below its cursor + t at
    random from it, in the `kernel_cases` tuple form. Causal: query row j
    of a slot sees its cursor + 1 + j keys."""
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    dh = D_MODEL // HEADS
    es = torch.tensor([], dtype=dt).element_size()
    g = torch.Generator(device=dev).manual_seed(seed)
    pool = SLOTS * n_pages + 1
    kp, vp = (torch.randn(pool, PAGE, HEADS, dh, generator=g,
                          device=dev).to(dt) for _ in range(2))
    qd = torch.randn(SLOTS, t, HEADS, dh, generator=g, device=dev).to(dt)
    perm = np.random.RandomState(seed).permutation(np.arange(1, pool))
    table = np.zeros((SLOTS, n_pages), np.int32)
    for s in range(SLOTS):
        n = -(-(pos[s] + t) // PAGE)
        table[s, :n] = perm[s * n_pages: s * n_pages + n]
    table_t = torch.tensor(table, device=dev)
    pos_t = torch.tensor(np.asarray(pos, np.int32), device=dev)
    keys = sum(p + t for p in pos)
    visible = sum(p + 1 + j for p in pos for j in range(t))
    return ("paged_decode_attention",
            f"q[{SLOTS},{t},{HEADS},{dh}] pool[{pool},{PAGE},{HEADS},{dh}] "
            f"pos={list(pos)}",
            lambda: fa.paged_decode_attention(qd, kp, vp, table_t, pos_t,
                                              True),
            lambda: fa.paged_gather_dense(qd, kp, vp, table_t, pos_t, True),
            None,
            2 * keys * HEADS * dh * es + 2 * SLOTS * t * HEADS * dh * es
            + table.nbytes + 4 * SLOTS,
            4 * dh * HEADS * visible)


def train_kernel_cases(torch, dev, dtype_name, conf):
    """The training kernels at the train phase's shapes, in the same tuple
    form as `kernel_cases`; a library entry that is a pair is timed as the
    first call less the second (SDPA's backward: forward + backward less
    the forward)."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import fused_update

    dt = getattr(torch, dtype_name)
    es = torch.tensor([], dtype=dt).element_size()
    rng = np.random.RandomState(1)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.randn(*shape) * scale, dtype=dt, device=dev)

    B, T, dh = TRAIN_B, CACHE, D_MODEL // HEADS
    n, rows = B * T * HEADS * dh, B * HEADS * T
    scale = dh ** -0.5
    q, k, v, do = (t(B, T, HEADS, dh) for _ in range(4))
    qh, kh, vh, doh = (a.transpose(1, 2).contiguous() for a in (q, k, v, do))
    qg, kg, vg = (a.detach().requires_grad_(True) for a in (qh, kh, vh))
    cases = []
    # The LM's causal step, then the transformer classifier's unmasked
    # (non-causal) step at the same shape (the masked phase).
    for causal in (True, False):
        # (q, k) pairs: the causal half, or all of them.
        pairs = B * HEADS * (T * (T + 1) // 2 if causal else T * T)
        shape = f"[{B},{T},{HEADS},{dh}] " + ("causal" if causal
                                              else "non-causal")

        def sdpa_fwd(causal=causal):
            return F.scaled_dot_product_attention(qg, kg, vg,
                                                  is_causal=causal)

        def sdpa_fwd_bwd(sdpa_fwd=sdpa_fwd):
            return torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), doh)

        o, lse = fa.dense_attention_lse(q, k, v, causal)
        drow = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = (q, k, v, do, lse, drow, causal, scale)
        cases += [
            ("flash_attention_fwd_lse", shape,
             lambda causal=causal: fa.flash_attention_fwd_lse(q, k, v,
                                                              causal),
             lambda causal=causal: fa.dense_attention_lse(q, k, v, causal),
             lambda causal=causal: F.scaled_dot_product_attention(
                 qh, kh, vh, is_causal=causal),
             4 * n * es + 4 * rows, 4 * dh * pairs),
            ("flash_attention_bwd_dq", shape,
             lambda bwd=bwd: fa.flash_attention_bwd_dq(*bwd),
             lambda bwd=bwd: fa.flash_bwd_dq_plain(*bwd),
             (sdpa_fwd_bwd, sdpa_fwd),
             5 * n * es + 8 * rows, 6 * dh * pairs),
            ("flash_attention_bwd_dkv", shape,
             lambda bwd=bwd: fa.flash_attention_bwd_dkv(*bwd),
             lambda bwd=bwd: fa.flash_bwd_dkv_plain(*bwd),
             (sdpa_fwd_bwd, sdpa_fwd),
             6 * n * es + 8 * rows, 8 * dh * pairs),
        ]
    if dtype_name != "float32":
        return cases
    # Adam over the 24 layer vertices' f32 params and state (lr 3e-3, step
    # 5): the step's `apply_step`, one launch over all 66 tensors that
    # writes params and state, beside its plain version (per vertex
    # `adam_xla`, then `sub_`) and `torch._fused_adam_` over the same
    # lists; then `dispatch` per vertex, the kernel's deltas mode.
    hyper, lr, step = (0.9, 0.999, 1e-8), 3e-3, 5
    shapes = lm_update_shapes(conf)
    params0 = {v: {k: t(*s) for k, s in p.items()} for v, p in shapes.items()}
    grads = {v: {k: t(*s) for k, s in p.items()} for v, p in shapes.items()}
    init = {v: {"m": {k: t(*s, scale=0.01) for k, s in p.items()},
                "v": {k: t(*s, scale=0.01) ** 2 for k, s in p.items()}}
            for v, p in shapes.items()}

    def copy(tree):
        return {v: {f: ({k: a.clone() for k, a in s.items()}
                        if isinstance(s, dict) else s.clone())
                    for f, s in st.items()} for v, st in tree.items()}

    kp, kst, pp, pst, lp, lst = (copy(params0), copy(init), copy(params0),
                                 copy(init), copy(params0), copy(init))

    tables = {}

    def apply_kernel():  # as the engine calls it: items built per step,
        # the packed table kept from step to step
        states = fused_update.apply_step("adam", hyper, [
            fused_update.UpdateItem(kp[v], kst[v], grads[v], lr)
            for v in shapes], step, 1.0, tables)
        kst.update(zip(shapes, states))
        return [a for v in shapes for a in (*kp[v].values(),
                                            *kst[v]["m"].values(),
                                            *kst[v]["v"].values())]

    def apply_plain():
        out = []
        for v in shapes:
            pst[v], d = fused_update.adam_xla(pst[v], grads[v], lr, step,
                                              *hyper)
            fused_update.apply_deltas(pp[v], d, None, 1.0)
            out += [*pp[v].values(), *pst[v]["m"].values(),
                    *pst[v]["v"].values()]
        return out

    dstate, dplain = copy(init), copy(init)

    def run(update, state):
        out = []
        for v in shapes:
            st, deltas = update(state[v], grads[v])
            out += [*st["m"].values(), *st["v"].values(), *deltas.values()]
        return out

    fg = [a for p in grads.values() for a in p.values()]
    fparams = [a for p in lp.values() for a in p.values()]
    fm, fv = ([a for st in lst.values() for a in st[f].values()]
              for f in ("m", "v"))
    steps = [torch.tensor(float(step + 1), device=dev) for _ in fg]
    elems = sum(a.numel() for a in fg)
    cases += [
        ("fused_update", lm_update_label(shapes),
         apply_kernel, apply_plain,
         lambda: torch._fused_adam_(
             fparams, fg, fm, fv, [], steps, amsgrad=False, lr=lr,
             beta1=hyper[0], beta2=hyper[1], weight_decay=0.0, eps=hyper[2],
             maximize=False, grad_scale=None, found_inf=None),
         28 * elems, 15 * elems),
        ("fused_update", f"adam dispatch per layer vertex (deltas mode), "
         f"{len(shapes)} launches, {elems} f32 params",
         lambda: run(lambda st, g: fused_update.dispatch(
             "adam", st, g, lr, step, hyper), dstate),
         lambda: run(lambda st, g: fused_update.adam_xla(
             st, g, lr, step, *hyper), dplain),
         None, 24 * elems, 15 * elems)]
    return cases + [lenet_update_case(torch, dev)]


def lenet_update_case(torch, dev):
    """Row 9 at LeNet's update: Nesterovs 0.9 over its 4 layers' 8 f32
    tensors (431,080 params; lr 0.01, step 5), one `apply_step` as `fit`
    runs it, beside its plain version (per layer `nesterovs_xla`, then
    `sub_`) and `torch._fused_sgd_` with Nesterov momentum over the same
    lists (the same update with the velocity scaled by -1 / lr). Bytes: p,
    g and v read, p and v written, 20 B a param."""
    from deeplearning4j_tpu_torch.kernels import fused_update
    from deeplearning4j_tpu_torch.models import zoo

    rng = np.random.RandomState(3)
    hyper, lr, step = (0.9,), 0.01, 5
    shapes = {f"layer_{i}": layer.param_shapes()
              for i, layer in enumerate(zoo.lenet_mnist().layers)
              if layer.param_shapes()}

    def tree(scale):
        return {v: {k: torch.tensor(rng.randn(*s) * scale,
                                    dtype=torch.float32, device=dev)
                    for k, s in p.items()} for v, p in shapes.items()}

    params0, grads, vel0 = tree(0.05), tree(0.01), tree(1e-4)

    def copy(t):
        return {v: {k: a.clone() for k, a in p.items()} for v, p in t.items()}

    kp, kv, pp, pv, lp, lv = (copy(params0), copy(vel0), copy(params0),
                              copy(vel0), copy(params0), copy(vel0))
    kst = {v: {"v": kv[v]} for v in shapes}
    tables = {}

    def apply_kernel():
        states = fused_update.apply_step("nesterovs", hyper, [
            fused_update.UpdateItem(kp[v], kst[v], grads[v], lr)
            for v in shapes], step, 1.0, tables)
        kst.update(zip(shapes, states))
        return [a for v in shapes for a in (*kp[v].values(),
                                            *kst[v]["v"].values())]

    pst = {v: {"v": pv[v]} for v in shapes}

    def apply_plain():
        out = []
        for v in shapes:
            pst[v], d = fused_update.nesterovs_xla(pst[v], grads[v], lr, step,
                                                   *hyper)
            fused_update.apply_deltas(pp[v], d, None, 1.0)
            out += [*pp[v].values(), *pst[v]["v"].values()]
        return out

    fparams, fg, fbuf = ([a for p in t.values() for a in p.values()]
                         for t in (lp, grads, lv))
    lib = None
    if hasattr(torch, "_fused_sgd_"):
        def lib():
            torch._fused_sgd_(fparams, fg, fbuf, weight_decay=0.0,
                              momentum=hyper[0], lr=lr, dampening=0.0,
                              nesterov=True, maximize=False,
                              is_first_step=False)
    elems = sum(a.numel() for a in fg)
    return ("fused_update", lenet_update_label(shapes, elems), apply_kernel,
            apply_plain, lib, 20 * elems, 7 * elems)


def lenet_update_label(shapes, elems):
    n = sum(len(p) for p in shapes.values())
    return (f"nesterovs apply_step over LeNet's {len(shapes)} layers "
            f"({n} tensors), {elems} f32 params")


def lm_update_shapes(conf):
    """{vertex: {param: shape}} of the LM's layer vertices."""
    return {name: v.layer.param_shapes() for name, v in conf.vertices.items()
            if hasattr(v, "layer") and v.layer.param_shapes()}


def lm_update_label(shapes):
    """The kernels phase's shape label of the step's update."""
    n = sum(len(p) for p in shapes.values())
    elems = sum(int(np.prod(s)) for p in shapes.values() for s in p.values())
    return (f"adam apply_step over {len(shapes)} layer vertices "
            f"({n} tensors), {elems} f32 params")


def _lib_ms(torch, lib, reps=25, warmup=5):
    """(event-timed ms, profiler ms) of a library yardstick, or Nones. Long
    calls (few reps) are not profiled: see `phase_long_kernels`."""
    if lib is None:
        return None, None
    kw = dict(reps=reps, warmup=warmup)
    profiled = reps >= 20
    if isinstance(lib, tuple):
        full, part = lib
        dev = (device_ms(torch, full), device_ms(torch, part)) if profiled \
            else (None, None)
        return (time_ms(full, **kw) - time_ms(part, **kw),
                None if None in dev else dev[0] - dev[1])
    return time_ms(lib, **kw), device_ms(torch, lib) if profiled else None


def phase_kernels(card, torch, dev, train_conf):
    """Each kernel against its plain version at its main path's shapes. The
    flash rows 3, 5 and 6 are also held row by row (`flash_compare`) and
    name the form of their kernel (`variant`: "wgmma" for bf16 at D = 64,
    "cuda_cores" for f32); row 8 is held row by row too (ROW_TOL)."""
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    rows = []
    for dtype in ("bfloat16", "float32"):
        cases = (kernel_cases(torch, dev, dtype)
                 + train_kernel_cases(torch, dev, dtype, train_conf))
        for name, shape, kern, plain, lib, nbytes, ops, *ref in cases:
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            extra, tol = {}, f"rtol=atol={TOL[dtype]}"
            if name in RESIDENT_ROWS:
                err, ok, row_err = flash_compare(name, got, want, dtype)
                tol = flash_tolerance(name, dtype)
                extra = {"max_row_rel_err": row_err,
                         "variant": fa.resident_variant(
                             getattr(torch, dtype), D_MODEL // HEADS)}
            elif name == "paged_decode_attention":
                # Past a few hundred keys a row's |o| is ~sqrt(e / keys),
                # under TOL: the rows hold it (a zero or a wrong page
                # is off by ~1 of the row's norm).
                err, ok = compare(got, want, dtype)
                row_err, row_ok = compare_rows(got, want, dtype)
                ok = ok and row_ok
                tol += f", rows {ROW_TOL[dtype]}"
                extra = {"max_row_rel_err": row_err}
            else:
                err, ok = compare(got, want, dtype)
            bound_ms, bound_by = bound(nbytes, ops, dtype)
            lib_ms, lib_dev_ms = _lib_ms(torch, lib)
            dev_ms = device_ms(torch, kern)
            if ref:  # a reference point beside the row, not its library
                label, fn = ref[0]
                extra.update(reference=label, reference_ms=time_ms(fn),
                             reference_device_ms=device_ms(torch, fn))
            rows.append({
                "name": name, "dtype": dtype, "shape": shape,
                "max_abs_err": err, "tolerance": tol, **extra,
                "ok": ok, "ms": time_ms(kern), "plain_ms": time_ms(plain),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms,
                # The wrapper's host time per call (launch path).
                "host_ms": host_ms(kern),
                "library_host_ms": None if lib is None or isinstance(
                    lib, tuple) else host_ms(lib),
                # Kernel time alone (profiler): `ms` above is one call as
                # the card's clock sees it, launch gaps included.
                "device_ms": dev_ms,
                "bound_share_by_device": bound_share(bound_ms, dev_ms),
                "plain_device_ms": device_ms(torch, plain),
                "library_device_ms": lib_dev_ms})
            emit(card, phase="kernels", **rows[-1])
            del got, want
        del cases
        torch.cuda.empty_cache()
    return rows


def post(url, body, timeout=300):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase_serve(card, torch, kernels, cg):
    from deeplearning4j_tpu_torch.serving import InferenceServer

    rng = np.random.RandomState(7)
    p = {n: rng.randint(0, VOCAB, n).tolist() for n in (40, 300, 700, 1000)}
    extra = {n: rng.randint(0, VOCAB, n).tolist() for n in (41, 301, 701)}
    bodies = [
        {"prompt_ids": p[40], "n_steps": 16, "temperature": 0},
        {"prompt_ids": p[300], "n_steps": 20, "temperature": 0},
        {"prompt_ids": p[700], "n_steps": 24, "temperature": 0},
        {"prompt_ids": p[1000], "n_steps": 24, "temperature": 0},
        {"prompt_ids": extra[41], "n_steps": 18, "temperature": 0.8,
         "seed": 11},
        {"prompt_ids": extra[301], "n_steps": 16, "temperature": 0},
        {"prompt_ids": extra[701], "n_steps": 20, "temperature": 0},
        # The repeat of the 300-token prompt: a prefix-cache hit.
        {"prompt_ids": p[300], "n_steps": 20, "temperature": 0},
    ]
    server = InferenceServer(cg, device=cg.device, kv_cache="paged",
                             kv_page_size=PAGE, decode_slots=SLOTS).start()
    try:
        sched = server.get(None).scheduler
        kernels.reset_counts()
        results, errors = {}, []

        def send(i):
            try:
                results[i] = post(server.url, bodies[i])["ids"]
            except Exception as e:  # reported below; the phase fails
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(bodies))]
        # The 300-token prompt goes first and alone until it is prefilled
        # (and so in the prefix cache); then the rest, its repeat among them.
        threads[1].start()
        while sched.stats["prefills"] < 1 and time.perf_counter() - t0 < 120:
            time.sleep(0.005)
        for i, th in enumerate(threads):
            if i != 1:
                th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernels.counts()
        stats = dict(sched.stats)
        ttft = sorted(sched.ttft_s)
    finally:
        server.stop()

    for i, body in enumerate(bodies):
        ids = results.get(i)
        if ids is None:
            continue
        prompt, n = body["prompt_ids"], body["n_steps"]
        if len(ids) != len(prompt) + n or ids[:len(prompt)] != prompt:
            errors.append(f"request {i}: {len(ids)} ids, want "
                          f"{len(prompt)} + {n} starting with the prompt")
        if not all(0 <= t < VOCAB for t in ids):
            errors.append(f"request {i}: an id outside [0, {VOCAB})")
    if results.get(1) != results.get(7):
        errors.append("the prefix-cache hit decoded other ids than the "
                      "fresh prefill of the same greedy prompt")
    pf, steps = stats["prefills"], stats["decode_steps"]
    want = {name: 0 for name in KERNEL_INFO}  # training kernels: none
    want.update({"layernorm_norm_act": (2 * BLOCKS + 1) * (pf + steps),
                 "flash_attention": BLOCKS * pf,
                 "paged_decode_attention": BLOCKS * steps})
    if stats["prefix_hits"] < 1:
        errors.append("no prefix-cache hit")
    if counts["launches"] != want:
        errors.append(f"launches {counts['launches']} != expected {want}")
    if any(counts["plain_calls"].values()):
        errors.append(f"plain versions ran on the card: "
                      f"{counts['plain_calls']}")
    if any(counts["launches"][k] == 0 for k in SERVING_KERNELS):
        errors.append(f"a kernel never launched: {counts['launches']}")
    errors += _variant_errors(counts, {"flash_attention": BLOCKS * pf})
    emit(card, phase="serve", ok=not errors, errors=errors,
         requests=len(bodies), completed=len(results), wall_s=wall,
         prefills=pf, prefix_hits=stats["prefix_hits"], decode_steps=steps,
         launches=counts["launches"], plain_calls=counts["plain_calls"],
         variants=counts["variants"]["flash_attention"],
         expected_launches=want,
         ttft_s={"median": statistics.median(ttft) if ttft else None,
                 "max": ttft[-1] if ttft else None, "all": ttft},
         decode_tokens=stats["decode_tokens"],
         decode_seconds=stats["decode_seconds"],
         decode_tok_s=(stats["decode_tokens"] / stats["decode_seconds"]
                       if stats["decode_seconds"] else None),
         decode_step_ms=(1e3 * stats["decode_seconds"] / steps
                         if steps else None))
    return not errors, counts["launches"]


def phase_parity(card, torch, cg, conf):
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.models.zoo import PagedDecodeStepper
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    cpu = ComputationGraph(conf, device="cpu").init(params={
        v: {k: a.cpu() for k, a in p.items()}
        for v, p in cg.params_tree.items()})
    prompt = np.random.RandomState(3).randint(0, VOCAB, 300).tolist()
    kernels.reset_counts()
    steppers = [PagedDecodeStepper(net, SLOTS, page_size=PAGE)
                for net in (cg, cpu)]
    probs = []
    for st in steppers:
        pr, state, n = st.prefill(prompt, pad_to=512)
        st.install(0, state, n)
        probs.append(pr)
    diffs = [float(np.abs(probs[0] - probs[1]).max())]
    agree = [int(probs[0].argmax()) == int(probs[1].argmax())]
    for _ in range(4):
        tok = int(probs[0].argmax())  # both sides fed the card's choice
        probs = [st.step([tok] + [0] * (SLOTS - 1))[0] for st in steppers]
        diffs.append(float(np.abs(probs[0] - probs[1]).max()))
        agree.append(int(probs[0].argmax()) == int(probs[1].argmax()))
    # The card's one prefill: row 3 once per block, on the tensor cores.
    counts = kernels.counts()
    errors = _variant_errors(counts, {"flash_attention": BLOCKS})
    if not (max(diffs) <= 4e-2 and all(np.isfinite(diffs))):
        errors.append(f"probabilities differ: {diffs}")
    emit(card, phase="parity", ok=not errors, errors=errors, tolerance=4e-2,
         max_abs_prob_diff=diffs, argmax_agrees=agree, prompt_len=300,
         variants=counts["variants"]["flash_attention"])
    return not errors


def lm_batches(seed, b, t, n):
    """n batches of a learnable id rule: each next id is a fixed
    permutation of the current one, from a random first id per row.
    Features are int64 ids [b, t, 1], labels int32 [b, t]."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(VOCAB)
    out = []
    for _ in range(n):
        ids = np.empty((b, t + 1), np.int64)
        ids[:, 0] = rng.randint(0, VOCAB, b)
        for j in range(t):
            ids[:, j + 1] = perm[ids[:, j]]
        out.append((ids[:, :-1, None], ids[:, 1:].astype(np.int32)))
    return out


def phase_train(card, torch, kernels, conf, dev):
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    net = ComputationGraph(conf, device=dev).init()
    # Batches staged on the card once, as a device-side input pipeline
    # would hold them: a step then copies nothing from the host.
    batches = [MultiDataSet([torch.as_tensor(x, device=dev)],
                            [torch.as_tensor(y, device=dev)])
               for x, y in lm_batches(17, TRAIN_B, CACHE, 2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    scores, wall = [], []
    for i in range(WARMUP + TIMED):
        t0 = time.perf_counter()
        net.fit(batches[i % 2])
        scores.append(net.score_value)  # reads the loss: syncs the step
        wall.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.counts()
    steps = WARMUP + TIMED
    errors, want = _launch_errors(counts, TRAIN_LAUNCHES, steps)
    errors += _variant_errors(counts, {name: BLOCKS * steps
                                       for name in TRAIN_FLASH})
    if not all(np.isfinite(scores)):
        errors.append(f"non-finite score: {scores}")
    last3 = float(np.mean(scores[-3:]))
    if not last3 <= 0.95 * scores[0]:
        errors.append(f"scores did not fall 5%: first {scores[0]}, mean of "
                      f"the last 3 {last3}")
    timed = wall[WARMUP:]
    ms = statistics.mean(timed)
    emit(card, phase="train", ok=not errors, errors=errors,
         model=f"transformer_lm V={VOCAB} T={CACHE} d={D_MODEL} "
               f"heads={HEADS} blocks={BLOCKS} mixed_bfloat16 Adam",
         batch=TRAIN_B, tokens_per_step=TRAIN_B * CACHE, steps=steps,
         scores=scores, first_score=scores[0], last3_mean=last3,
         ms_per_step=ms, ms_per_step_median=statistics.median(timed),
         ms_per_step_all=wall, tokens_per_s=TRAIN_B * CACHE / ms * 1e3,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         launches=counts["launches"], expected_launches=want,
         variants={k: counts["variants"][k] for k in TRAIN_FLASH},
         plain_calls=counts["plain_calls"])
    return (not errors, counts["launches"], net, batches,
            statistics.median(timed))


def _m_errors(got, want):
    """Per layer vertex: max |m_got - m_want| over max |m_want| (Adam's m
    after one step is 0.1 * grad)."""
    out = {}
    for name, st in want.opt_state.items():
        ref = max(float(a.abs().max()) for a in st["m"].values())
        err = max(float((got.opt_state[name]["m"][k].cpu() - a.cpu())
                        .abs().max()) for k, a in st["m"].items())
        out[name] = err / ref if ref else float("inf")
    return out


def phase_train_parity(card, torch, dev):
    """One fit step at B=2 from the same seeded params, on the card and on
    the CPU (plain versions), in f32 and in the smoke model's bf16.

    f32 is the gate that catches a kernel wrapper that cut the gradient:
    scores within 4e-2 relative and, per layer vertex, Adam's m within
    4e-2 * max|m_cpu|. In bf16 the scores are held to 4e-2; the m of each
    bf16 path is measured against the CPU's f32 m, and the card's may be
    no further from it than 4e-2 or twice the CPU bf16 path's own
    distance, whichever is larger (both paths round to bf16 at other
    places, and the gradients of the layers deepest from the loss carry
    the most rounding)."""
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    (x, y), = lm_batches(23, 2, CACHE, 1)
    t0 = time.perf_counter()
    nets, errors, forms = {}, [], {}
    for dtype, short in (("bfloat16", "bf16"), ("float32", "f32")):
        conf = zoo.transformer_lm(VOCAB, t=CACHE, d_model=D_MODEL,
                                  n_heads=HEADS, n_blocks=BLOCKS, dtype=dtype)
        kernels.reset_counts()
        for where, d in (("card", dev), ("cpu", "cpu")):
            net = ComputationGraph(conf, device=d).init()  # same seed
            net.fit(MultiDataSet([x], [y]))
            nets[f"{where}_{short}"] = net
        # The card's step (the CPU's runs plain versions): rows 5 and 6 on
        # the tensor cores in bf16, on the CUDA cores in f32.
        forms[short] = {n: kernels.counts()["variants"][n]
                        for n in TRAIN_FLASH}
        form = "wgmma" if short == "bf16" else "cuda_cores"
        want = {"wgmma": 0, "cuda_cores": 0, form: BLOCKS}
        if any(f != want for f in forms[short].values()):
            errors.append(f"{short} card step launches by form "
                          f"{forms[short]}, want {want} each")
    seconds = time.perf_counter() - t0
    score = {k: n.score_value for k, n in nets.items()}

    def rel(a, b):
        return abs(score[a] - score[b]) / abs(score[b])

    m_f32 = _m_errors(nets["card_f32"], nets["cpu_f32"])
    m_bf16 = _m_errors(nets["card_bf16"], nets["cpu_bf16"])
    card_vs_f32 = _m_errors(nets["card_bf16"], nets["cpu_f32"])
    cpu_vs_f32 = _m_errors(nets["cpu_bf16"], nets["cpu_f32"])
    if not (rel("card_f32", "cpu_f32") <= 4e-2
            and rel("card_bf16", "cpu_bf16") <= 4e-2):
        errors.append(f"scores differ: {score}")
    if max(m_f32.values()) > 4e-2:
        errors.append(f"f32 m differs: {m_f32}")
    over = {v: e for v, e in card_vs_f32.items()
            if e > max(4e-2, 2 * cpu_vs_f32[v])}
    if over:
        errors.append(f"bf16 m of the card further from f32 than allowed: "
                      f"{over}")
    emit(card, phase="train_parity", ok=not errors, errors=errors, batch=2,
         tolerance=4e-2, scores=score,
         score_rel_diff={"f32": rel("card_f32", "cpu_f32"),
                         "bf16": rel("card_bf16", "cpu_bf16")},
         m_err_over_max_f32_card_vs_cpu=m_f32,
         m_err_over_max_bf16_card_vs_cpu=m_bf16,
         m_err_over_max_card_bf16_vs_cpu_f32=card_vs_f32,
         m_err_over_max_cpu_bf16_vs_cpu_f32=cpu_vs_f32, variants=forms,
         seconds=seconds)
    return not errors


def _kernel_summary(torch, events, wall_ms, reps=1):
    busy_ms = sum(e - s for _, s, e in events) / reps / 1e3
    by_name = {}
    for name, s, e in events:
        n_us = by_name.setdefault(name[:90], [0, 0.0])
        n_us[0] += 1
        n_us[1] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "kernels_per_call": len(events) / reps,
            "top": [{"kernel": k, "per_call": c / reps,
                     "ms_per_call": us / reps / 1e3}
                    for k, (c, us) in top]}


def trace_train_step(torch, net, batch):
    """One fit call with its three parts (`_train_forward`,
    `_train_backward`, `_train_update`) wrapped on the instance: each part
    runs alone on the card (synchronized before and after) under its own
    profiler, so its host wall time and kernel time are its own; a part
    that runs more than once in the call (a truncated-BPTT chunk each) is
    summed over its runs. The update part also records the PyTorch ops it
    ran on the host (`aten_ops`), which show a `sub_`/`add_` pass whether
    or not its one short kernel reaches the device trace (PERF.md §7)."""
    from torch.profiler import ProfilerActivity, profile

    parts, update_ops = {}, {}

    def wrap(part, fn):
        acts = [ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if part == "update" else [])

        def run(*args):
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            w0, ev0, n0 = parts.get(part, (0.0, [], 0))
            events = prof.events()
            parts[part] = (w0 + wall, ev0 + [
                (e.name, e.time_range.start, e.time_range.end)
                for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA], n0 + 1)
            if part == "update":
                for e in events:
                    if (e.device_type == torch.autograd.DeviceType.CPU
                            and e.name.startswith("aten::")):
                        update_ops[e.name] = update_ops.get(e.name, 0) + 1
            return out
        return run

    names = (("_train_forward", "forward"), ("_train_backward", "backward"),
             ("_train_update", "update"))
    for attr, part in names:
        setattr(net, attr, wrap(part, getattr(net, attr)))
    try:
        net.fit(batch)
    finally:
        for attr, _ in names:
            delattr(net, attr)
    out = {}
    for part, (wall, ev, runs) in parts.items():
        out[part] = ({"wall_ms": wall, "device_ms": "not measured"}
                     if not ev else _kernel_summary(torch, ev, wall))
        out[part]["runs"] = runs
    out["update"]["aten_ops"] = update_ops
    return out


def _update_errors(step_trace, what):
    """Errors unless a traced step's update part ran no `sub_`/`add_`/`mul`
    op on the host: no pass over deltas. The one launch per update is held
    by the phases' launch counts."""
    passes = {n: c for n, c in step_trace["update"]["aten_ops"].items()
              if n.split("::")[1].rstrip("_") in ("sub", "add", "mul")}
    return ([f"{what}: the update ran elementwise ops: {passes}"]
            if passes else [])


def trace_long_attention(torch, net, batch, reps=3):
    """Device time per call, at the long-context shape ([1, 32768, 8, 64]
    bf16, causal), of causal SDPA's forward and of its forward + backward
    (the yardsticks of rows 4 and 7), of row 4, and of row 13 (row 4 over
    the triangular and the rectangular list at 4 heads), read inside one
    profiler window that also holds a long-context fit step: profiled
    alone, a few such calls came back with none or some of their kernels
    (PERF.md §7). A spin kernel (`torch.cuda._sleep`) marks where each
    group of calls starts. Returns ms per call by group, or "not
    measured"."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, do = (torch.randn(1, LONG_T, HEADS, D_MODEL // HEADS,
                               generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    qh, kh, vh, doh = (a.transpose(1, 2).contiguous() for a in (q, k, v, do))
    qg, kg, vg = (a.detach().requires_grad_(True) for a in (qh, kh, vh))
    q4, k4, v4 = (a[:, :, :ROW13_HEADS].contiguous() * 0.5
                  for a in (q, k, v))
    calls = {"sdpa_causal": lambda: F.scaled_dot_product_attention(
                 qh, kh, vh, is_causal=True),
             "sdpa_causal_fwd_bwd": lambda: torch.autograd.grad(
                 F.scaled_dot_product_attention(qg, kg, vg, is_causal=True),
                 (qg, kg, vg), doh),
             "row4": lambda: fa.flash_attention_stream(q, k, v, True),
             "row13_triangle": lambda: fa.flash_attention_stream(
                 q4, k4, v4, True, with_lse=False),
             "row13_rectangle": lambda: fa.flash_attention_stream(
                 q4, k4, v4, True, with_lse=False, pairs="rectangle")}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        net.fit(batch)
        for fn in calls.values():
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    ev = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    marks = [i for i, (_, _, n) in enumerate(ev) if "spin_kernel" in n]
    if len(marks) != len(calls):
        return {"device_ms": "not measured", "events": len(ev)}
    out = {}
    for (what, _), lo, hi in zip(calls.items(), marks,
                                  marks[1:] + [len(ev)]):
        by_name = {}
        for s0, s1, name in ev[lo + 1:hi]:
            by_name[name[:90]] = by_name.get(name[:90], 0.0) + (s1 - s0)
        out[what] = {"device_ms_per_call": sum(by_name.values()) / reps
                     / 1e3,
                     "by_kernel_ms_per_call": {n: us / reps / 1e3
                                               for n, us in by_name.items()}}
    # Row 4 in the fit step: its unit kernels and their merges (the merge
    # kernel serves row 4 alone).
    units = [n for _, _, n in ev[:marks[0]] if "stream_fwd_wgmma" in n]
    us = sum(s1 - s0 for s0, s1, n in ev[:marks[0]]
             if "stream_fwd_wgmma" in n or "stream_merge_kernel" in n)
    out["row4_in_fit_step"] = {
        "launches": len(units),
        "device_ms_per_launch": us / max(len(units), 1) / 1e3}
    return out


def phase_trace(card, torch, cg, train_net, train_batch, rn_nets,
                rn_batches, rnn_net, rnn_batch, long_net, long_batch,
                mnist):
    """Where the time of one decode step (4 slots at depths 1000, 700, 300,
    40), of one 1024-token prefill, of the three parts of one LM training
    step, of one T1 and one T2 ResNet step, of one char-RNN fit call (two
    tBPTT chunks), of one char-RNN `rnn_time_step` (one character, one
    stream), of one LeNet and one MLP `fit` call at B=128 (whole, its host
    copy of the batch included, and by part; `mnist`: {model: (net,
    DataSet)}) and of the three parts of one long-context training step
    (B=1, T=32,768) goes: host wall time per call, kernel time on the card,
    the card's idle share, and the top kernels."""
    from deeplearning4j_tpu_torch.models.zoo import PagedDecodeStepper
    from deeplearning4j_tpu_torch.serving.scheduler import (
        prompt_bucket_ladder,
    )

    from deeplearning4j_tpu_torch import kernels

    kernels.reset_counts()
    rng = np.random.RandomState(5)
    ladder = prompt_bucket_ladder(CACHE)
    st = PagedDecodeStepper(cg, SLOTS, page_size=PAGE)
    for slot, n in enumerate((1000, 700, 300, 40)):
        _, state, length = st.prefill(rng.randint(0, VOCAB, n).tolist(),
                                      pad_to=next(b for b in ladder if b >= n))
        st.install(slot, state, length)
    prompt = rng.randint(0, VOCAB, 1000).tolist()
    char = np.eye(RNN_V, dtype=np.float32)[[3]]
    rnn_net.rnn_clear_previous_state()  # one stream from here on
    reps = {"decode_step": 8, "prefill_1024": 3, "rnn_time_step": 20}
    calls = {"decode_step": lambda: st.step([1] * SLOTS),
             "prefill_1024": lambda: st.prefill(prompt, pad_to=CACHE),
             "rnn_time_step": lambda: rnn_net.rnn_time_step(char)}
    for model, (net, ds) in mnist.items():
        # Reading the score waits for the step.
        reps[f"{model}_fit_call"] = 20
        calls[f"{model}_fit_call"] = (
            lambda net=net, ds=ds: net.fit(ds).score_value)
    out = {}
    for what, fn in calls.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps[what]):
            fn()  # ends in a host copy of the distributions: synchronous
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps[what]
        ev = device_kernels(torch, fn, reps[what])
        out[what] = ({"wall_ms": wall_ms, "device_ms": "not measured"}
                     if ev is None
                     else _kernel_summary(torch, ev, wall_ms, reps[what]))
    out["train_step"] = trace_train_step(torch, train_net, train_batch)
    for path in ("t1", "t2"):
        out[f"resnet_{path}_step"] = trace_train_step(
            torch, rn_nets[path], rn_batches[path][0])
    out["rnn_fit_call"] = trace_train_step(torch, rnn_net, rnn_batch)
    for model, (net, ds) in mnist.items():
        out[f"{model}_fit_step"] = trace_train_step(torch, net, ds)
    out["long_train_step"] = trace_train_step(torch, long_net, long_batch)
    out["long_attention"] = trace_long_attention(torch, long_net, long_batch)
    # Every row 3, 5 and 6 launch of the traced prefills and LM step took
    # the tensor-core form.
    counts = kernels.counts()
    launched = {n: counts["launches"][n] for n in RESIDENT_ROWS}
    errors = _variant_errors(counts, launched)
    if not all(launched.values()):
        errors.append(f"a resident flash row never launched: {launched}")
    for what in ("train_step", "resnet_t1_step", "resnet_t2_step",
                 "rnn_fit_call", "long_train_step",
                 *(f"{model}_fit_step" for model in mnist)):
        errors += _update_errors(out[what], what)
    emit(card, phase="trace", ok=not errors, errors=errors,
         variants={n: counts["variants"][n] for n in RESIDENT_ROWS}, **out)
    return out, not errors


# ---------------------------------------------------------------- char-RNN


def rnn_cell_cases(torch, dev, dtype_name):
    """Row 10 at the char-RNN's shapes: (label, kernel fn, plain fn at the
    dtype, plain fn in f32 on the same inputs, library fn or None, bytes,
    ops). The train shape (B=32, n=256, peepholes, no mask), the sampling
    shape (B=1) and the 32 streams of sampling, then n=200 (the zoo's
    default) and the masked and no-peephole variants at B=32."""
    from deeplearning4j_tpu_torch.kernels import lstm_cell as lc

    dt = getattr(torch, dtype_name)
    es = torch.tensor([], dtype=dt).element_size()
    g = torch.Generator(device=dev).manual_seed(91)
    cases = []
    for b, n, peep, masked in ((RNN_B, RNN_H, True, False),
                               (1, RNN_H, True, False),
                               (RNN_B, 200, True, False),
                               (RNN_B, RNN_H, True, True),
                               (RNN_B, RNN_H, False, False)):
        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev)
                    * scale).to(dt)

        # xw_t as the scan hands it over: one time step of [b, T, 4n].
        xw = rnd(b, RNN_CHUNK, 4 * n).unbind(1)[7]
        h, c = rnd(b, n, scale=0.5), rnd(b, n)
        rw = rnd(n, 4 * n, scale=n ** -0.5)
        pw = rnd(3 * n, scale=0.3) if peep else None
        m = ((torch.rand(b, generator=g, device=dev) < 0.7).to(dt)
             if masked else None)
        args = (xw, h, c, rw, pw, m)
        f32 = tuple(None if a is None else a.float() for a in args)
        lib = None
        if not peep and not masked:
            # PyTorch's LSTM cell (gate order i, f, g, o) on the same step:
            # the recurrent product, then the fused gates. Columns reordered
            # once, as a caller keeping that layout would hold them.
            order = torch.cat([torch.arange(k * n, (k + 1) * n, device=dev)
                               for k in (0, 1, 3, 2)])
            rw_l, xw_l = rw[:, order].contiguous(), xw[:, order].contiguous()

            def lib(h=h, c=c, rw_l=rw_l, xw_l=xw_l):
                return torch.ops.aten._thnn_fused_lstm_cell(
                    xw_l, torch.mm(h, rw_l), c)
        label = (f"B={b} n={n}" + (" peephole" if peep else "")
                 + (" masked" if masked else ""))
        nbytes = (b * 4 * n + 2 * b * n + 4 * n * n + (3 * n if peep else 0)
                  + (b if masked else 0) + 3 * b * n) * es
        # The recurrent product's multiply-adds, ~25 operations per unit
        # for the gates, peepholes and cell (transcendentals counted once).
        ops = 2 * b * n * 4 * n + 25 * b * n
        cases.append((
            "lstm_cell", label,
            lambda args=args: lc.lstm_cell(*args, "sigmoid", "tanh"),
            lambda args=args: lc.lstm_cell_plain(*args, "sigmoid", "tanh"),
            lambda f32=f32: lc.lstm_cell_plain(*f32, "sigmoid", "tanh"),
            lib, nbytes, ops))
    return cases


def phase_rnn_kernels(card, torch, dev):
    """f32 is held to the plain version at 1e-4 (TF32 off); bf16 to the
    plain version run in f32 on the same inputs at 4e-2: the kernel, like
    the TPU body, keeps z = xw + h @ RW and the gates in f32, where the
    plain version in bf16 rounds z (its distance is printed beside)."""
    rows = []
    for dtype in ("float32", "bfloat16"):
        for name, shape, kern, plain, plain_f32, lib, nbytes, ops in \
                rnn_cell_cases(torch, dev, dtype):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err_dtype, ok = compare(got, want, dtype)
            err = err_dtype
            if dtype != "float32":
                err, ok = compare(got, plain_f32(), dtype)
            bound_ms, bound_by = bound(nbytes, ops, dtype)
            lib_ms, lib_dev_ms, lib_error = _safe_lib_ms(torch, lib)
            dev_ms = device_ms(torch, kern)
            rows.append({
                "name": name, "dtype": dtype, "shape": shape,
                "max_abs_err": err,
                "held_to": ("plain version in f32 on the same inputs"
                            if dtype != "float32" else
                            "plain version in float32"),
                "max_abs_err_vs_plain_at_dtype": err_dtype,
                "tolerance": f"rtol=atol={TOL[dtype]}", "ok": ok,
                "ms": time_ms(kern), "plain_ms": time_ms(plain),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms, "library_error": lib_error,
                "library_covers": (
                    "torch.mm + aten._thnn_fused_lstm_cell: the same step "
                    "without peepholes or mask" if lib else None),
                # The wrapper's host time per call (launch path).
                "host_ms": host_ms(kern),
                "library_host_ms": None if lib is None else host_ms(lib),
                "device_ms": dev_ms,
                "bound_share_by_device": bound_share(bound_ms, dev_ms),
                "plain_device_ms": device_ms(torch, plain),
                "library_device_ms": lib_dev_ms})
            emit(card, phase="rnn_kernels", **rows[-1])
    return rows


def rnn_batches(torch, dev, b, t, n, seed):
    """n learnable batches on the card: each next character is a fixed
    permutation of the current one, from a random first character per
    row; one-hot f32 features and labels [b, t, V]."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    rng = np.random.RandomState(seed)
    perm = rng.permutation(RNN_V)
    eye = torch.eye(RNN_V, device=dev)
    out = []
    for _ in range(n):
        ids = np.empty((b, t + 1), np.int64)
        ids[:, 0] = rng.randint(0, RNN_V, b)
        for j in range(t):
            ids[:, j + 1] = perm[ids[:, j]]
        ids = torch.as_tensor(ids, device=dev)
        out.append(DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]]))
    return out, perm


def _rnn_conf():
    from deeplearning4j_tpu_torch.models import zoo

    return zoo.char_rnn(vocab_size=RNN_V, hidden=RNN_H, layers=RNN_LAYERS,
                        tbptt_length=RNN_CHUNK)


def phase_rnn_train(card, torch, kernels, dev):
    """The full-width char-RNN trained with `MultiLayerNetwork.fit` under
    truncated BPTT: 3 warm-up and 10 timed calls over 2 batches."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(_rnn_conf(), device=dev).init()
    batches, perm = rnn_batches(torch, dev, RNN_B, RNN_T, 2, 19)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    scores, wall = [], []
    for i in range(RNN_WARMUP + RNN_TIMED):
        t0 = time.perf_counter()
        net.fit(batches[i % 2])
        scores.append(net.score_value)  # reads the loss: syncs the call
        wall.append((time.perf_counter() - t0) * 1e3)
    calls = RNN_WARMUP + RNN_TIMED
    counts = kernels.counts()
    errors, want = _launch_errors(counts, RNN_LAUNCHES, calls)
    if not all(np.isfinite(scores)):
        errors.append(f"non-finite score: {scores}")
    last3 = float(np.mean(scores[-3:]))
    if not last3 < scores[0]:
        errors.append(f"scores did not fall: first {scores[0]}, mean of the "
                      f"last 3 {last3}")
    if net.iteration != calls:
        errors.append(f"iteration {net.iteration} after {calls} sequences")
    timed = wall[RNN_WARMUP:]
    ms = statistics.mean(timed)
    emit(card, phase="rnn_train", ok=not errors, errors=errors,
         model=f"char_rnn V={RNN_V} hidden={RNN_H} layers={RNN_LAYERS} f32 "
               f"RMSProp lr 0.1, tBPTT {RNN_CHUNK}",
         batch=RNN_B, seq_len=RNN_T, calls=calls, scores=scores,
         first_score=scores[0], last3_mean=last3, ms_per_call=ms,
         ms_per_call_median=statistics.median(timed), ms_per_call_all=wall,
         sequences_per_s=RNN_B / ms * 1e3,
         characters_per_s=RNN_B * RNN_T / ms * 1e3,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         launches=counts["launches"], expected_launches=want,
         plain_calls=counts["plain_calls"])
    return not errors, counts["launches"], net, batches, perm


def phase_rnn_sample(card, torch, kernels, net, perm):
    """Greedy sampling through `rnn_time_step`, one character per call:
    200 from one seed character, then 200 steps of 32 streams at once.
    Each call launches 2 cells; the stateful outputs must equal `output`
    over the whole sampled sequence (f32, 1e-4)."""
    eye = np.eye(RNN_V, dtype=np.float32)
    errors, res, launches = [], {}, {name: 0 for name in KERNEL_INFO}
    for streams in (1, RNN_B):
        seeds = np.arange(streams) * 5 % RNN_V
        net.rnn_clear_previous_state()
        kernels.reset_counts()
        ids, probs, wall = [seeds], [], []
        for _ in range(RNN_SAMPLE):
            t0 = time.perf_counter()
            p = net.rnn_time_step(eye[ids[-1]])  # [streams, V], on the host
            wall.append((time.perf_counter() - t0) * 1e3)
            probs.append(p)
            ids.append(p.argmax(-1))
        counts = kernels.counts()
        errs, _ = _launch_errors(counts, {"lstm_cell": RNN_LAYERS},
                                     RNN_SAMPLE)
        errors += [f"{streams} streams: {e}" for e in errs]
        for k, v in counts["launches"].items():
            launches[k] += v
        stepped = np.stack(probs, 1)
        full = net.output(eye[np.stack(ids[:-1], 1)])
        diff = float(np.abs(stepped - full).max())
        if not diff <= 1e-4:
            errors.append(f"{streams} streams: rnn_time_step differs from "
                          f"output by {diff}")
        follows = float(np.mean(np.stack(ids[1:], 1)
                                == perm[np.stack(ids[:-1], 1)]))
        ms = statistics.mean(wall[5:])
        res[f"streams_{streams}"] = {
            "calls": RNN_SAMPLE, "ms_per_character_step": ms,
            "ms_per_step_median": statistics.median(wall[5:]),
            "characters_per_s": streams / ms * 1e3,
            "max_abs_diff_vs_output": diff,
            "share_following_the_trained_rule": follows,
            "first_ids": [int(i) for i in np.stack(ids, 1)[0, :24]],
            "launches": counts["launches"]["lstm_cell"]}
    emit(card, phase="rnn_sample", ok=not errors, errors=errors, **res)
    return not errors, launches


def _g2_errors(got, want):
    """Per layer: max |g2_got - g2_want| over the layer's largest g2."""
    out = {}
    for name, st in want.opt_state.items():
        ref = max(float(a.abs().max()) for a in st["g2"].values())
        err = max(float((got.opt_state[name]["g2"][k].cpu() - a).abs().max())
                  for k, a in st["g2"].items())
        out[name] = err / ref if ref else float("inf")
    return out


def phase_rnn_parity(card, torch, dev):
    """f32, B=4, T=100: the same seeded params on the card and on the CPU
    (plain versions): `output` within 1e-3, one tBPTT `fit` call's score
    within 1e-3 relative, and per layer RMSProp's g2 within 4e-2 of the
    CPU's largest g2 there (a cut gradient shows as an error near 1)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    (ds,), _ = rnn_batches(torch, "cpu", RNN_PARITY_B, RNN_T, 1, 29)
    x, y = ds.features.numpy(), ds.labels.numpy()
    t0 = time.perf_counter()
    cpu = MultiLayerNetwork(_rnn_conf(), device="cpu").init()
    card_net = MultiLayerNetwork(_rnn_conf(), device=dev).init(params={
        k: {n: a.detach() for n, a in p.items()}
        for k, p in cpu.params_tree.items()})
    prob_diff = float(np.abs(card_net.output(x) - cpu.output(x)).max())
    for net in (cpu, card_net):
        net.fit(DataSet(x, y))
    score_rel = abs(card_net.score_value - cpu.score_value) / abs(
        cpu.score_value)
    g2 = _g2_errors(card_net, cpu)
    errors = []
    if prob_diff > 1e-3:
        errors.append(f"output differs by {prob_diff}")
    if score_rel > 1e-3:
        errors.append(f"scores {card_net.score_value} (card) vs "
                      f"{cpu.score_value} (CPU)")
    if max(g2.values()) > 4e-2:
        errors.append(f"g2 differs: {g2}")
    emit(card, phase="rnn_parity", ok=not errors, errors=errors,
         batch=RNN_PARITY_B, seq_len=RNN_T, max_abs_prob_diff=prob_diff,
         score_card=card_net.score_value, score_cpu=cpu.score_value,
         score_rel_diff=score_rel, g2_err_over_max=g2,
         seconds=time.perf_counter() - t0)
    return not errors


# ------------------------------------------------------------ LeNet, MLP


def _mnist_conf(model):
    from deeplearning4j_tpu_torch.models import zoo

    return zoo.lenet_mnist() if model == "lenet" else zoo.mlp_mnist()


def phase_mnist_train(card, torch, kernels, dev, model):
    """LeNet (`model` "lenet") or the MLP ("mlp") at full width, seeded
    random weights, as the examples run it: `set_listeners` (score every
    100 iterations, `PerformanceListener(100, sync=True)`, every score
    collected, and a clock that synchronizes and reads the time at each
    iteration), one `fit` epoch of `MnistDataSetIterator(128)` (each batch
    copied from host numpy to the card inside `fit`), then `evaluate` on
    the test set. Exactly one update launch a step and nothing else, 0
    plain calls; the listener fired at iterations 1..469; scores finite,
    the mean of the last 50 under that of the first 50; 10,000 test images
    counted, accuracy >= 0.95."""
    from deeplearning4j_tpu_torch.datasets.builtin import (
        MnistDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import listeners as ls

    class StepClock(ls.IterationListener):
        def __init__(self):
            self.marks = []

        def on_epoch_start(self, model):
            torch.cuda.synchronize(dev)
            self.marks.append(time.perf_counter())

        def iteration_done(self, model, iteration):
            torch.cuda.synchronize(dev)
            self.marks.append(time.perf_counter())

    flat = model == "mlp"
    t0 = time.perf_counter()
    train = MnistDataSetIterator(MNIST_B, train=True, flat=flat)
    test = MnistDataSetIterator(MNIST_B, train=False, flat=flat)
    data_s = time.perf_counter() - t0
    net = MultiLayerNetwork(_mnist_conf(model), device=dev).init()
    log, clock = [], StepClock()
    scores = ls.CollectScoresIterationListener(1)
    net.set_listeners(ls.ScoreIterationListener(100, out=log.append),
                      ls.PerformanceListener(100, sync=True, out=log.append),
                      scores, clock)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    kernels.reset_counts()
    t0 = time.perf_counter()
    net.fit(train)
    epoch_s = time.perf_counter() - t0
    counts = kernels.counts()
    errors, want = _launch_errors(counts, MNIST_LAUNCHES, MNIST_STEPS)
    iters = [i for i, _ in scores.scores]
    if iters != list(range(1, MNIST_STEPS + 1)):
        errors.append(f"listener iterations {iters[:3]}..{iters[-3:]} "
                      f"({len(iters)}), not 1..{MNIST_STEPS}")
    vals = [s for _, s in scores.scores]
    first50, last50 = (float(np.mean(vals[:50])), float(np.mean(vals[-50:])))
    if not all(np.isfinite(vals)):
        errors.append("non-finite score")
    if not last50 < first50:
        errors.append(f"scores did not fall: first 50 {first50}, last 50 "
                      f"{last50}")
    if (net.iteration, net.epoch) != (MNIST_STEPS, 1):
        errors.append(f"iteration {net.iteration}, epoch {net.epoch}")
    step_ms = [(b - a) * 1e3 for a, b in zip(clock.marks, clock.marks[1:])]
    timed = step_ms[MNIST_WARMUP:]
    ms = statistics.median(timed)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    ev = net.evaluate(test)
    eval_s = time.perf_counter() - t0
    total = int(ev.confusion.matrix.sum())
    if total != MNIST_TEST_N:
        errors.append(f"confusion total {total} != {MNIST_TEST_N}")
    if not ev.accuracy() >= MNIST_ACCURACY:
        errors.append(f"accuracy {ev.accuracy()} < {MNIST_ACCURACY}")
    first = next(iter(train))
    emit(card, phase=f"{model}_train", ok=not errors, errors=errors,
         model=(f"{model}_mnist f32, Nesterovs 0.9 lr "
                f"{net.layers[0].learning_rate}, "
                f"{net.num_params()} params"),
         batch=MNIST_B, steps=MNIST_STEPS,
         last_batch=MNIST_TRAIN_N - (MNIST_STEPS - 1) * MNIST_B,
         ms_per_step_median=ms, ms_per_step_mean=statistics.mean(timed),
         ms_per_step_p90=float(np.percentile(timed, 90)),
         images_per_s=MNIST_B / ms * 1e3,
         epoch_s=epoch_s, epoch_images_per_s=MNIST_TRAIN_N / epoch_s,
         host_to_device_bytes_per_batch=int(first.features.nbytes
                                            + first.labels.nbytes),
         max_memory_allocated_bytes=peak,
         # the earlier phases' tensors still held are in both
         peak_over_start_bytes=peak - start_bytes, data_build_s=data_s,
         first_score=vals[0], first50_mean=first50, last50_mean=last50,
         accuracy=ev.accuracy(), precision=ev.precision(),
         recall=ev.recall(), f1=ev.f1(), confusion_total=total,
         evaluate_s=eval_s, listener_log=log[:3] + log[-2:],
         launches=counts["launches"], expected_launches=want,
         plain_calls=counts["plain_calls"])
    return not errors, counts["launches"], (net, first)


def _lenet_params(torch):
    """LeNet's params from one seeded numpy draw: weights N(0, 2 / (fan in
    + fan out)) (xavier; HWIO kernels' fans over the taps), biases
    N(0, 0.01^2)."""
    rng = np.random.RandomState(41)
    out = {}
    for i, layer in enumerate(_mnist_conf("lenet").layers):
        p = {}
        for k, s in layer.param_shapes().items():
            if len(s) == 1:
                a = rng.randn(*s) * 0.01
            else:
                taps = int(np.prod(s[:-2]))
                a = rng.randn(*s) * (2.0 / (taps * (s[-2] + s[-1]))) ** 0.5
            p[k] = torch.tensor(a, dtype=torch.float32)
        out[f"layer_{i}"] = p
    return out


def _tree_errors(got, want, tol):
    """Names whose tensors differ beyond rtol / atol, with the largest
    excess |got - want| - (atol + rtol |want|) of each."""
    bad = {}
    for lk, p in want.items():
        for k, a in p.items():
            g = got[lk][k].detach().cpu()
            excess = float(((g - a.detach()).abs() - tol["atol"]
                            - tol["rtol"] * a.detach().abs()).max())
            if excess > 0:
                bad[f"{lk}/{k}"] = excess
    return bad


def phase_lenet_parity(card, torch, dev, trained):
    """f32, B=128: LeNet from one seeded numpy params tree on the card and
    on the CPU (plain versions), 3 `fit` steps on the first 384 training
    images: per step the scores within 1e-4 relative, the params and the
    Nesterovs velocity within rtol 2e-4, atol 1e-5; then `output` on 256
    test images within 1e-4. Three steps from random weights leave the
    outputs near uniform, where top-1 / top-2 near-ties are certain (the
    smallest margin over 256 images is ~1e-7 to ~1e-4), so `evaluate` is
    held on lenet_train's trained net (`trained`) and a CPU net with its
    params: counts over the 10,000 test images equal, once the CPU's
    smallest top-1 / top-2 margin exceeds 1e-4 (a near-tie fails)."""
    from deeplearning4j_tpu_torch.datasets.builtin import load_mnist
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    t0 = time.perf_counter()
    params = _lenet_params(torch)
    cpu = MultiLayerNetwork(_mnist_conf("lenet"), device="cpu").init(
        params=params)
    card_net = MultiLayerNetwork(_mnist_conf("lenet"), device=dev).init(
        params=params)
    train = load_mnist(train=True, num_examples=LENET_PARITY_STEPS * MNIST_B)
    errors, steps = [], []
    for i, ds in enumerate(train.batch_by(MNIST_B)):
        for net in (cpu, card_net):
            net.fit(ds)
        rel = abs(card_net.score_value - cpu.score_value) / abs(
            cpu.score_value)
        bad_p = _tree_errors(card_net.params_tree, cpu.params_tree,
                             LENET_PARAM_TOL)
        bad_v = _tree_errors(
            {k: s["v"] for k, s in card_net.opt_state.items()},
            {k: s["v"] for k, s in cpu.opt_state.items() if s["v"]},
            LENET_PARAM_TOL)
        steps.append({"score_card": card_net.score_value,
                      "score_cpu": cpu.score_value, "score_rel_diff": rel,
                      "params_over_tol": bad_p, "velocity_over_tol": bad_v})
        if rel > 1e-4 or bad_p or bad_v:
            errors.append(f"step {i}: {steps[-1]}")
    test = load_mnist(train=False, num_examples=LENET_PARITY_EVAL)
    prob_diff = float(np.abs(card_net.output(test.features)
                             - cpu.output(test.features)).max())
    if prob_diff > 1e-4:
        errors.append(f"output differs by {prob_diff}")
    test = DataSet(*(lambda d: (d.features, d.labels))(
        load_mnist(train=False)))
    trained_cpu = MultiLayerNetwork(_mnist_conf("lenet"), device="cpu").init(
        params={k: {n: a.detach() for n, a in p.items()}
                for k, p in trained.params_tree.items()})
    want = trained_cpu.output(test.features)
    top2 = np.sort(want, axis=-1)[:, -2:]
    margin = float((top2[:, 1] - top2[:, 0]).min())
    trained_diff = float(np.abs(trained.output(test.features) - want).max())
    counts_equal = None
    if margin <= NEAR_TIE:
        errors.append(f"near-tie: smallest top-1 / top-2 margin {margin}")
    else:
        ev_card, ev_cpu = trained.evaluate(test), trained_cpu.evaluate(test)
        counts_equal = bool(np.array_equal(ev_card.confusion.matrix,
                                           ev_cpu.confusion.matrix))
        if not counts_equal:
            errors.append("evaluate counts differ")
    emit(card, phase="lenet_parity", ok=not errors, errors=errors,
         batch=MNIST_B, steps=steps, max_abs_prob_diff=prob_diff,
         output_images=LENET_PARITY_EVAL, eval_images=MNIST_TEST_N,
         trained_max_abs_prob_diff=trained_diff, min_top2_margin=margin,
         evaluate_counts_equal=counts_equal,
         seconds=time.perf_counter() - t0)
    return not errors


# --------------------------------------------------------------- the DSL


def _first(out):
    """A graph's first output, or a MultiLayerNetwork's output."""
    return out[0] if isinstance(out, list) else out


def _card_window(kernels, want, fn):
    """Run `fn` with the counts from 0; (its result, the launches, errors
    unless they are exactly `want` with no plain call)."""
    kernels.reset_counts()
    result = fn()
    counts = kernels.counts()
    errors, _ = _launch_errors(counts, want, 1)
    return result, counts["launches"], errors


def _zip_round_trip(torch, kernels, dev, name, net, x, batch):
    """`save_model`, `load_model` on the card, and the checks of the dsl
    phase's part (a)."""
    from deeplearning4j_tpu_torch.util import model_serializer as ms

    os.makedirs(DSL_DIR, exist_ok=True)
    path = os.path.join(DSL_DIR, f"{name}.zip")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms.save_model(net, path)
    save_s = time.perf_counter() - t0
    zip_bytes = os.path.getsize(path)
    t0 = time.perf_counter()
    loaded = ms.load_model(path, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    os.remove(path)
    errors = []
    if not np.array_equal(loaded.params(), net.params()):
        errors.append("params differ")
    if not np.array_equal(loaded.updater_state_flat(),
                          net.updater_state_flat()):
        errors.append("updater state differs")
    if set(loaded.state) != set(net.state) or not all(
            torch.equal(loaded.state[lk][k], v)
            for lk, sub in net.state.items() for k, v in sub.items()):
        errors.append("layer state differs")
    if (loaded.iteration, loaded.epoch) != (net.iteration, net.epoch):
        errors.append(f"counters {loaded.iteration, loaded.epoch} != "
                      f"{net.iteration, net.epoch}")

    def drive():
        outs = [_first(n.output(x)) for n in (net, net, loaded)]
        scores = []
        for n in (net, loaded):
            n.fit(batch)
            scores.append(n.score_value)
        return outs, scores

    (outs, scores), launches, errs = _card_window(
        kernels, DSL_LAUNCHES[name], drive)
    errors += errs
    self_gap = float(np.abs(outs[0] - outs[1]).max())
    loaded_gap = float(np.abs(outs[2] - outs[0]).max())
    if loaded_gap > self_gap:
        errors.append(f"reloaded output off by {loaded_gap}, beyond the "
                      f"trained net's own gap {self_gap}")
    rel = abs(scores[1] - scores[0]) / abs(scores[0])
    if not rel <= DSL_REFIT_TOL:
        errors.append(f"further step scores {scores} differ by {rel}")
    report = dict(save_s=save_s, load_s=load_s, zip_bytes=zip_bytes,
                  num_params=net.num_params(),
                  output_bitwise_equal=loaded_gap == 0.0,
                  output_max_abs_diff=loaded_gap,
                  trained_self_gap=self_gap, further_step_scores=scores,
                  further_step_rel_diff=rel)
    del loaded
    torch.cuda.empty_cache()
    return errors, launches, report


def _multi_io_conf():
    """`examples/csv_graph_multi_io.py`'s graph through the port's
    builder."""
    from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        DenseLayer,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        NeuralNetConfiguration,
    )

    return (NeuralNetConfiguration.builder()
            .seed(7).learning_rate(0.05).updater("adam")
            .graph_builder()
            .add_inputs("ina", "inb")
            .add_layer("da", DenseLayer(n_out=16, activation="relu"), "ina")
            .add_layer("db", DenseLayer(n_out=16, activation="relu"), "inb")
            .add_vertex("m", MergeVertex(), "da", "db")
            .add_layer("cls", OutputLayer(n_out=3, activation="softmax",
                                          loss_function="mcxent"), "m")
            .add_layer("reg", OutputLayer(n_out=2, activation="identity",
                                          loss_function="mse"), "m")
            .set_outputs("cls", "reg")
            .set_input_types(InputType.feed_forward(4),
                             InputType.feed_forward(3))
            .build())


def _vertex_graph_conf():
    """Every vertex kind in one graph at width DSL_WIDTH: inputs "seq"
    [b, t, w] and "vec" [b, w]; a dense layer on each, the vector copied
    along time and added to the sequence, reversed, its last step merged
    with the vector, subset, the five elementwise ops, scale, shift, L2
    normalization, a stack of two and its halves, their L2 distance, a
    preprocessor vertex to NHWC and a dense layer the builder gives a
    CnnToFeedForward preprocessor, merged into a softmax head (the CPU
    tests hold the same graph at width 8 to the JAX package)."""
    from deeplearning4j_tpu_torch.nn.conf import graph as G
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        DenseLayer,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
        FeedForwardToCnnPreProcessor,
    )

    w = DSL_WIDTH
    gb = (NeuralNetConfiguration.builder().seed(5).learning_rate(0.05)
          .updater("adam").weight_init("xavier")
          .graph_builder().add_inputs("seq", "vec"))
    gb.add_layer("d_seq", DenseLayer(n_out=w, activation="tanh"), "seq")
    gb.add_layer("d_vec", DenseLayer(n_out=w, activation="tanh"), "vec")
    gb.add_vertex("dup", G.DuplicateToTimeSeriesVertex(input_name="seq"),
                  "d_vec")
    gb.add_vertex("seqsum", G.ElementWiseVertex(op="add"), "d_seq", "dup")
    gb.add_vertex("rev", G.ReverseTimeSeriesVertex(), "seqsum")
    gb.add_vertex("last", G.LastTimeStepVertex(), "rev")
    gb.add_vertex("merge", G.MergeVertex(), "last", "d_vec")
    gb.add_vertex("sub", G.SubsetVertex(from_index=w // 2,
                                        to_index=w // 2 + w - 1), "merge")
    gb.add_vertex("e_add", G.ElementWiseVertex(op="add"), "sub", "d_vec",
                  "last")
    gb.add_vertex("e_sub", G.ElementWiseVertex(op="subtract"), "e_add",
                  "d_vec")
    gb.add_vertex("e_prod", G.ElementWiseVertex(op="product"), "e_sub",
                  "last")
    gb.add_vertex("e_avg", G.ElementWiseVertex(op="average"), "e_prod", "sub")
    gb.add_vertex("e_max", G.ElementWiseVertex(op="max"), "e_avg", "d_vec")
    gb.add_vertex("scale", G.ScaleVertex(scale_factor=0.5), "e_max")
    gb.add_vertex("shift", G.ShiftVertex(shift_factor=0.1), "scale")
    gb.add_vertex("l2n", G.L2NormalizeVertex(), "shift")
    gb.add_vertex("stack", G.StackVertex(), "l2n", "sub")
    gb.add_vertex("un0", G.UnstackVertex(from_index=0, stack_size=2), "stack")
    gb.add_vertex("un1", G.UnstackVertex(from_index=1, stack_size=2), "stack")
    gb.add_vertex("l2", G.L2Vertex(), "un0", "un1")
    gb.add_vertex("cnn", G.PreprocessorVertex(
        preprocessor=FeedForwardToCnnPreProcessor(2, 2, w // 4)), "un1")
    gb.add_layer("d_cnn", DenseLayer(n_out=w, activation="relu"), "cnn")
    gb.add_vertex("head", G.MergeVertex(), "l2", "d_cnn", "un0")
    gb.add_layer("out", OutputLayer(n_out=DSL_CLASSES, activation="softmax",
                                    loss_function="mcxent"), "head")
    return (gb.set_outputs("out")
            .set_input_types(InputType.recurrent(w, DSL_T),
                             InputType.feed_forward(w))
            .build())


def _card_and_cpu(torch, dev, conf_fn):
    """One net on the card from the conf's seed, and one on the CPU with
    a copy of its params."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    card_net = ComputationGraph(conf_fn(), device=dev).init()
    cpu_net = ComputationGraph(conf_fn(), device="cpu").init(params={
        v: {k: t.detach().cpu() for k, t in p.items()}
        for v, p in card_net.params_tree.items()})
    return card_net, cpu_net


def phase_dsl(card, torch, kernels, dev, t2_net, t2_batch, lenet_net,
              lenet_batch):
    """The dsl phase (see the module docstring): (a) the zip round trips
    of T2 and LeNet, (b) the multi-input graph card vs CPU, (c) the
    all-vertex graph card vs CPU."""
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet

    t0 = time.perf_counter()
    errors, parts = [], {}
    launches = {name: 0 for name in KERNEL_INFO}

    def add(part, part_errors, part_launches):
        errors.extend(f"{part}: {e}" for e in part_errors)
        for k, v in part_launches.items():
            launches[k] += v

    for name, net, x, batch in (
            ("t2", t2_net, t2_batch.features[0], t2_batch),
            ("lenet", lenet_net, lenet_batch.features, lenet_batch)):
        errs, got, parts[name] = _zip_round_trip(torch, kernels, dev, name,
                                                 net, x, batch)
        add(name, errs, got)

    card_net, cpu_net = _card_and_cpu(torch, dev, _multi_io_conf)
    rng = np.random.RandomState(7)
    batches = []
    for _ in range(DSL_MULTI_STEPS):
        b = DSL_MULTI_B
        batches.append(MultiDataSet(
            [rng.rand(b, 4).astype(np.float32),
             rng.rand(b, 3).astype(np.float32)],
            [np.eye(3, dtype=np.float32)[rng.randint(0, 3, b)],
             rng.rand(b, 2).astype(np.float32)]))

    def steps(net):
        out = []
        for mds in batches:
            net.fit(mds)
            out.append(net.score_value)
        return out

    card_scores, got, errs = _card_window(kernels, DSL_LAUNCHES["multi_io"],
                                          lambda: steps(card_net))
    add("multi_io", errs, got)
    cpu_scores = steps(cpu_net)
    rels = [abs(a - b) / abs(b) for a, b in zip(card_scores, cpu_scores)]
    if not max(rels) <= DSL_SCORE_TOL:
        errors.append(f"multi_io: scores differ by up to {max(rels)}")
    parts["multi_io"] = dict(steps=DSL_MULTI_STEPS, batch=DSL_MULTI_B,
                             card_scores=card_scores, cpu_scores=cpu_scores,
                             max_rel_diff=max(rels))

    card_net, cpu_net = _card_and_cpu(torch, dev, _vertex_graph_conf)
    rng = np.random.RandomState(9)
    seq = rng.randn(DSL_B, DSL_T, DSL_WIDTH).astype(np.float32)
    vec = rng.randn(DSL_B, DSL_WIDTH).astype(np.float32)
    y = np.eye(DSL_CLASSES, dtype=np.float32)[rng.randint(0, DSL_CLASSES,
                                                          DSL_B)]
    mds = MultiDataSet([seq, vec], [y])

    def vertex_step():
        out = card_net.output(seq, vec)[0]
        card_net.fit(mds)
        return out

    card_out, got, errs = _card_window(kernels, DSL_LAUNCHES["vertices"],
                                       vertex_step)
    add("vertices", errs, got)
    out_diff = float(np.abs(card_out - cpu_net.output(seq, vec)[0]).max())
    cpu_net.fit(mds)
    rel = (abs(card_net.score_value - cpu_net.score_value)
           / abs(cpu_net.score_value))
    m_err = _m_errors(card_net, cpu_net)
    if not out_diff <= DSL_SCORE_TOL:
        errors.append(f"vertices: output differs by {out_diff}")
    if not rel <= DSL_SCORE_TOL:
        errors.append(f"vertices: step scores differ by {rel}")
    if not max(m_err.values()) <= DSL_SCORE_TOL:
        errors.append(f"vertices: Adam m differs: {m_err}")
    kinds = sorted({type(v).__name__ for v in card_net.conf.vertices.values()})
    if len(kinds) != 14:
        errors.append(f"vertices: {len(kinds)} kinds, not 14: {kinds}")
    parts["vertices"] = dict(width=DSL_WIDTH, batch=DSL_B, seq_len=DSL_T,
                             kinds=kinds, output_max_abs_diff=out_diff,
                             score_rel_diff=rel, m_err_over_max=m_err)
    del card_net, cpu_net
    emit(card, phase="dsl", ok=not errors, errors=errors, **parts,
         launches=launches, seconds=time.perf_counter() - t0)
    return not errors, launches


# ---------------------------------------------------------- persistence


def _score_clock(torch):
    """A listener that reads each iteration's score (a sync) and the
    time."""
    from deeplearning4j_tpu_torch.optimize.listeners import IterationListener

    class Clock(IterationListener):
        def __init__(self):
            self.scores, self.marks = [], []

        def start(self):
            torch.cuda.synchronize()
            self.marks.append(time.perf_counter())

        def iteration_done(self, model, iteration):
            self.scores.append(model.score_value)
            self.marks.append(time.perf_counter())

        def step_ms(self):
            return [(b - a) * 1e3 for a, b in zip(self.marks,
                                                  self.marks[1:])]

    return Clock()


def _ckpt_lm_batches(torch, dev):
    """The ckpt phase's LM batches, staged on the card: step k (from 1)
    takes batch (k - 1) % 2, in the parent and in the child alike."""
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet

    return [MultiDataSet([torch.as_tensor(x, device=dev)],
                         [torch.as_tensor(y, device=dev)])
            for x, y in lm_batches(23, TRAIN_B, CACHE, 2)]


def _ckpt_lm_net(dev):
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    conf = zoo.transformer_lm(VOCAB, t=CACHE, d_model=D_MODEL, n_heads=HEADS,
                              n_blocks=BLOCKS, dtype="bfloat16")
    return ComputationGraph(conf, device=dev).init()


def _manager_hook(mgr):
    """A listener that gives the manager its cadence (`maybe_save`)."""
    from deeplearning4j_tpu_torch.optimize.listeners import IterationListener

    class Hook(IterationListener):
        def iteration_done(self, model, iteration):
            mgr.maybe_save(model)

    return Hook()


def ckpt_child(directory: str) -> int:
    """The ckpt phase's child (`chip_smoke.py --ckpt-child DIR`): the LM
    from its seed under a CheckpointManager (`save_every` 5, async) on
    `DIR/manager`, a sharded CheckpointListener on `DIR/listener` and the
    failure watchdog. Once the first chunk of the manager's step-10 save is
    on disk it prints `writing <step>` and holds that write there, so the
    parent's SIGKILL lands mid-write; training goes on until the kill."""
    import torch

    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
    from deeplearning4j_tpu_torch.checkpoint import array_store
    from deeplearning4j_tpu_torch.util.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.util.failure import FailureDetectionListener

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mgr_dir = os.path.join(directory, "manager")
    held = os.path.join(mgr_dir, f"step_{CKPT_KILL:08d}.tmp")
    write = array_store._fsync_write

    def fsync_write(path, data):
        n = write(path, data)
        if path.startswith(held):
            print(f"writing {CKPT_KILL}", flush=True)
            threading.Event().wait()  # until the kill
        return n

    array_store._fsync_write = fsync_write
    net = _ckpt_lm_net(dev)
    batches = _ckpt_lm_batches(torch, dev)
    mgr = CheckpointManager(mgr_dir, save_every=CKPT_EVERY, async_save=True,
                            device=dev)
    ckpts = CheckpointListener(os.path.join(directory, "listener"),
                               frequency=CKPT_EVERY, format="sharded")
    net.set_listeners(ckpts, FailureDetectionListener(ckpts,
                                                      check_frequency=1),
                      _manager_hook(mgr))
    print("training", flush=True)
    for k in range(1, CKPT_STEPS + 1):
        net.fit(batches[(k - 1) % 2])
    print("not killed", flush=True)
    return 3


def _run_child(directory):
    """Start the child, SIGKILL it when it says it is writing, and return
    (its output, the seconds from start to kill, whether it was killed
    mid-write)."""
    import signal

    out_path = os.path.join(directory, "child.log")
    with open(out_path, "w") as log:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), CKPT_CHILD_FLAG,
             directory], stdout=subprocess.PIPE, stderr=log, text=True)
    t0 = time.perf_counter()
    lines, killed = [], False
    timer = threading.Timer(CKPT_CHILD_TIMEOUT_S, child.kill)
    timer.start()
    try:
        for line in child.stdout:
            lines.append(line.strip())
            if line.startswith(f"writing {CKPT_KILL}"):
                os.kill(child.pid, signal.SIGKILL)
                killed = True
                break
    finally:
        timer.cancel()
        child.kill()
        child.wait()
        child.stdout.close()
    seconds = time.perf_counter() - t0
    with open(out_path) as f:
        lines += f.read().splitlines()[-20:]
    return lines, seconds, killed


def _same_tensors(torch, a, b):
    """Names of the leaves of two {vertex: {...: tensor}} trees that are
    not equal bit for bit."""
    from deeplearning4j_tpu_torch.checkpoint.store import _flat_items

    fa, fb = dict(_flat_items(a, "")), dict(_flat_items(b, ""))
    if set(fa) != set(fb):
        return ["keys differ"]
    return [k for k in fa if not torch.equal(fa[k], fb[k])]


def _net_diff(torch, a, b):
    """Params, updater state and layer state of `b` that differ from
    `a`'s, bit for bit, and the counters if they differ."""
    out = {f"params{k}": 1 for k in _same_tensors(torch, a.params_tree,
                                                   b.params_tree)}
    out.update({f"updater{k}": 1 for k in _same_tensors(torch, a.opt_state,
                                                         b.opt_state)})
    out.update({f"state{k}": 1 for k in _same_tensors(torch, a.state,
                                                       b.state)})
    if a.iteration != b.iteration:
        out["iteration"] = (a.iteration, b.iteration)
    return sorted(out)


def _ckpt_lm(torch, kernels, dev, train_ms):
    """Part (a) of the ckpt phase: the LM child killed mid-write, resumed
    in the parent, held to two uninterrupted runs; then the rollback."""
    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
    from deeplearning4j_tpu_torch.util.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.util.failure import FailureDetectionListener

    root = os.path.join(CKPT_DIR, "lm")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.cuda.empty_cache()  # room for the child's net
    errors, report, launches = [], {}, {name: 0 for name in KERNEL_INFO}
    batches = _ckpt_lm_batches(torch, dev)

    def window(fn, steps):
        _, got, errs = _card_window(kernels, {
            k: v * steps for k, v in TRAIN_LAUNCHES.items()}, fn)
        errors.extend(errs)
        for k, v in got.items():
            launches[k] += v

    # Two uninterrupted runs, the first under a manager (async saves every
    # 5 steps): its steps while a write is in flight are timed.
    runs, walls, in_flight = [], [], []
    ref_mgr = CheckpointManager(os.path.join(root, "uninterrupted"),
                                save_every=CKPT_EVERY, device=dev)
    for r in range(2):
        net = _ckpt_lm_net(dev)
        if r == 0:
            net.set_listeners(_manager_hook(ref_mgr))
        scores = []

        def run():
            for k in range(1, CKPT_STEPS + 1):
                busy = ref_mgr._writes.busy()
                t0 = time.perf_counter()
                net.fit(batches[(k - 1) % 2])
                scores.append(net.score_value)  # syncs the step
                if r == 0:
                    walls.append((time.perf_counter() - t0) * 1e3)
                    in_flight.append(busy)

        window(run, CKPT_STEPS)
        runs.append((net, scores))
    ref_mgr.flush()
    (ref, ref_scores), (twin, twin_scores) = runs
    runs_equal = not _net_diff(torch, ref, twin) and ref_scores == twin_scores
    if not runs_equal:
        errors.append(f"two uninterrupted runs differ: "
                      f"{_net_diff(torch, ref, twin)[:8]}")
    del twin, runs
    busy_ms = [w for w, b in zip(walls, in_flight) if b]
    report.update(
        uninterrupted_runs_equal=runs_equal, scores=ref_scores,
        snapshot_ms=ref_mgr.timings["checkpoint.snapshot"] * 1e3,
        write_s=ref_mgr.timings["checkpoint.write"],
        checkpoint_bytes=ref_mgr.stats["dl4j_checkpoint_bytes_written_total"]
        // ref_mgr.stats["dl4j_checkpoint_saves_total"],
        step_ms_all=walls, steps_with_write_in_flight=sum(in_flight),
        step_ms_with_write_in_flight_median=(
            statistics.median(busy_ms) if busy_ms else None),
        train_phase_step_ms_median=train_ms)
    if not busy_ms:
        errors.append("no step ran with a write in flight")

    # The child, killed while its step-10 save is being written.
    lines, child_s, killed = _run_child(root)
    mgr = CheckpointManager(os.path.join(root, "manager"), device=dev)
    held = mgr.step_path(CKPT_KILL)
    on_disk = sorted(os.listdir(mgr.directory))
    report.update(child_seconds=child_s, child_killed_mid_write=killed,
                  child_output=lines[-6:], manager_dir=on_disk)
    if not killed:
        errors.append(f"child not killed mid-write: {lines[-6:]}")
    if not os.path.isdir(held + ".tmp") or os.path.isdir(held) \
            or mgr.latest() != CKPT_EVERY:
        errors.append(f"after the kill: {on_disk}, latest {mgr.latest()}")

    # The resume: the newest committed step, onto a net built on the card.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = mgr.restore()
    torch.cuda.synchronize()
    report.update(restore_s=time.perf_counter() - t0,
                  restored_step=net.iteration)
    if net.iteration != CKPT_EVERY:
        errors.append(f"restored step {net.iteration}")
    ckpts = CheckpointListener(os.path.join(root, "parent_listener"),
                               frequency=CKPT_EVERY, format="sharded")
    watchdog = FailureDetectionListener(ckpts, check_frequency=1)
    clock = _score_clock(torch)
    net.set_listeners(ckpts, watchdog, clock)

    def resume():
        # One `fit` epoch: the listener's writes overlap the next steps.
        clock.start()
        net.fit([batches[(k - 1) % 2]
                 for k in range(net.iteration + 1, CKPT_STEPS + 1)])

    window(resume, CKPT_STEPS - CKPT_EVERY)
    resumed = clock.scores
    report.update(resumed_step_ms=clock.step_ms(),
                  listener_snapshot_ms=(
                      ckpts.timings["checkpoint.snapshot"] * 1e3),
                  listener_write_s=ckpts.timings["checkpoint.write"])
    diff = _net_diff(torch, ref, net)
    report.update(resumed_scores=resumed, resume_bitwise_equal=not diff
                  and resumed == ref_scores[CKPT_EVERY:])
    if not report["resume_bitwise_equal"]:
        errors.append(f"resume differs from the uninterrupted run: "
                      f"{diff[:8]}, scores {resumed} vs "
                      f"{ref_scores[CKPT_EVERY:]}")

    # The rollback: one param times NaN, 2 steps (the watchdog reads the
    # previous step's score: it rolls back at the second), 2 more.
    first = next(iter(net.params_tree.values()))
    leaf = next(iter(first.values()))
    with torch.no_grad():
        leaf.mul_(float("nan"))
    after = []

    def rollback():
        for k in range(CKPT_POISONED + 2):
            net.fit(batches[k % 2])
            after.append(net.score_value)
            if k == CKPT_POISONED - 1:
                after.append(_net_diff(torch, ref, net))
                restored = leaf.detach().clone()
        after.append(not torch.equal(leaf, restored))

    net.set_listeners(ckpts, watchdog)
    window(rollback, CKPT_POISONED + 2)
    moved = after.pop()
    at_rollback = after.pop(CKPT_POISONED)
    log = watchdog.recovery_log
    report.update(recoveries=watchdog.recoveries, rollback_log=[
        {k: v for k, v in e.items() if k != "dropped_checkpoints"}
        for e in log], scores_around_rollback=after,
        rollback_restored_the_step_15_state=not at_rollback,
        step_after_rollback_moved_params=moved)
    if watchdog.recoveries != 1 or log[0]["restored_iteration"] != \
            CKPT_STEPS:
        errors.append(f"rollback: {watchdog.recoveries} recoveries, "
                      f"{log}")
    if at_rollback or not moved:
        errors.append(f"rollback state differs {at_rollback[:8]} or the "
                      f"next step left the params ({moved})")
    if not all(np.isfinite(after[CKPT_POISONED:])):
        errors.append(f"scores after the rollback: {after}")
    del net, ref
    torch.cuda.empty_cache()
    return errors, launches, report


def _ckpt_t2(torch, kernels, dev):
    """Part (b): T2 under a zip CheckpointListener every 4 steps for 8,
    resumed from the step-4 zip and held to the uninterrupted run (and
    that run to a second one)."""
    from deeplearning4j_tpu_torch.util.checkpoint import (
        CheckpointListener,
        load_checkpoint,
    )

    root = os.path.join(CKPT_DIR, "t2")
    shutil.rmtree(root, ignore_errors=True)
    image, _, batch = RN_PATHS["t2"]
    batches = rn_batches(torch, dev, image, batch, 2, 71)
    errors, launches = [], {name: 0 for name in KERNEL_INFO}

    def window(fn, steps):
        _, got, errs = _card_window(kernels, {
            k: v * steps for k, v in RN_LAUNCHES["t2"].items()}, fn)
        errors.extend(errs)
        for k, v in got.items():
            launches[k] += v

    def steps(net, first, last):
        """Steps first..last as one `fit` epoch; their scores and wall
        times (ms, from the previous step's end)."""
        clock = _score_clock(torch)
        net.set_listeners(*net.listeners, clock)
        clock.start()
        net.fit([batches[(k - 1) % 2] for k in range(first, last + 1)])
        net.set_listeners(*net.listeners[:-1])
        return clock.scores, clock.step_ms()

    ref = _rn_net(torch, dev, "t2")
    ckpts = CheckpointListener(root, frequency=CKPT_T2_EVERY, keep_last=2)
    ref.set_listeners(ckpts)
    t0 = time.perf_counter()
    out = []
    window(lambda: out.append(steps(ref, 1, CKPT_T2_STEPS)), CKPT_T2_STEPS)
    epoch_s = time.perf_counter() - t0
    (ref_scores, ref_ms), = out
    snapshot_ms = ckpts.timings["checkpoint.snapshot"] * 1e3
    write_s = ckpts.timings["checkpoint.write"]
    twin = _rn_net(torch, dev, "t2")
    window(lambda: out.append(steps(twin, 1, CKPT_T2_STEPS)), CKPT_T2_STEPS)
    twin_scores = out[-1][0]
    runs_equal = not _net_diff(torch, ref, twin) and ref_scores == twin_scores
    if not runs_equal:
        errors.append(f"two uninterrupted runs differ: "
                      f"{_net_diff(torch, ref, twin)[:8]}")
    del twin
    path = ckpts.saved_paths[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = load_checkpoint(path, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    window(lambda: out.append(steps(net, net.iteration + 1, CKPT_T2_STEPS)),
           CKPT_T2_STEPS - CKPT_T2_EVERY)
    resumed = out[-1][0]
    diff = _net_diff(torch, ref, net)
    equal = not diff and resumed == ref_scores[CKPT_T2_EVERY:]
    if not equal:
        errors.append(f"zip resume differs: {diff[:8]}, scores {resumed} vs "
                      f"{ref_scores[CKPT_T2_EVERY:]}")
    bn = sum(len(s) for s in ref.state.values())
    report = dict(
        checkpoints=[os.path.basename(p) for p in ckpts.saved_paths],
        zip_bytes=os.path.getsize(path), snapshot_ms=snapshot_ms,
        write_s=write_s, epoch_s=epoch_s, step_ms_all=ref_ms,
        sync_save_model_s_dsl_phase=list(CKPT_T2_SYNC_SAVE_S), load_s=load_s,
        resumed_from_step=CKPT_T2_EVERY, uninterrupted_runs_equal=runs_equal,
        resume_bitwise_equal=equal, batchnorm_state_tensors=bn,
        scores=ref_scores, resumed_scores=resumed)
    del net, ref
    torch.cuda.empty_cache()
    return errors, launches, report


def _ckpt_m1(torch, kernels, dev):
    """Part (c): LeNet under early stopping over 2 epochs, its best model
    saved in both formats and reloaded on the card."""
    from deeplearning4j_tpu_torch.datasets.builtin import (
        MnistDataSetIterator,
    )
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator,
        EarlyStoppingConfiguration,
        EarlyStoppingTrainer,
        LocalFileModelSaver,
        MaxEpochsTerminationCondition,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    root = os.path.join(CKPT_DIR, "m1")
    shutil.rmtree(root, ignore_errors=True)
    savers = {fmt: LocalFileModelSaver(os.path.join(root, fmt), format=fmt,
                                       device=dev)
              for fmt in ("zip", "sharded")}
    test = MnistDataSetIterator(MNIST_B, train=False)
    probe = next(iter(test)).features
    saved = {}

    class BothFormats:
        """Saves through both savers and keeps `output` of what it saved
        on one test batch (twice: the card's own repeatability)."""

        def save_best_model(self, net, score):
            for saver in savers.values():
                saver.save_best_model(net, score)
            saved["outputs"] = [net.output(probe), net.output(probe)]
            saved["epoch"] = net.epoch

        def save_latest_model(self, net, score):
            for saver in savers.values():
                saver.save_latest_model(net, score)

        def get_best_model(self):
            return savers["zip"].get_best_model()

    net = MultiLayerNetwork(_mnist_conf("lenet"), device=dev).init()
    cfg = (EarlyStoppingConfiguration.builder()
           .score_calculator(DataSetLossCalculator(test))
           .model_saver(BothFormats())
           .epoch_termination_conditions(
               MaxEpochsTerminationCondition(CKPT_ES_EPOCHS))
           .build())
    trainer = EarlyStoppingTrainer(cfg, net, MnistDataSetIterator(MNIST_B))
    t0 = time.perf_counter()
    result, got, errors = _card_window(
        kernels, {k: v * CKPT_ES_EPOCHS * MNIST_STEPS
                  for k, v in MNIST_LAUNCHES.items()}, trainer.fit)
    fit_s = time.perf_counter() - t0
    want = saved["outputs"][0]
    self_gap = float(np.abs(saved["outputs"][1] - want).max())
    reloads = {}
    for fmt, saver in savers.items():
        best = saver.get_best_model()
        out = best.output(probe)
        reloads[fmt] = dict(equal=bool(np.array_equal(out, want)),
                            max_abs_diff=float(np.abs(out - want).max()),
                            iteration=best.iteration)
        if not reloads[fmt]["equal"]:
            errors.append(f"best model ({fmt}) reloads with output off by "
                          f"{reloads[fmt]['max_abs_diff']}")
    if (result.total_epochs, result.termination_details) != (
            CKPT_ES_EPOCHS, "MaxEpochsTerminationCondition"):
        errors.append(f"result {result.total_epochs} epochs, "
                      f"{result.termination_details}")
    scores = list(result.score_vs_epoch.values())
    if not all(np.isfinite(scores)):
        errors.append(f"scores {scores}")
    report = dict(epochs=result.total_epochs,
                  termination=result.termination_details,
                  score_vs_epoch=result.score_vs_epoch,
                  best_model_epoch=result.best_model_epoch,
                  best_model_score=result.best_model_score, fit_s=fit_s,
                  output_self_gap=self_gap, reloads=reloads)
    return errors, got, report


def phase_ckpt(card, torch, kernels, dev, train_ms):
    """The ckpt phase (see the module docstring): (a) the LM killed,
    resumed and rolled back, (b) T2's zip resume, (c) M1 under early
    stopping; launches in the card windows, 0 plain calls."""
    t0 = time.perf_counter()
    errors, parts = [], {}
    launches = {name: 0 for name in KERNEL_INFO}
    for name, part in (("lm", lambda: _ckpt_lm(torch, kernels, dev,
                                               train_ms)),
                       ("t2", lambda: _ckpt_t2(torch, kernels, dev)),
                       ("m1", lambda: _ckpt_m1(torch, kernels, dev))):
        errs, got, parts[name] = part()
        errors.extend(f"{name}: {e}" for e in errs)
        for k, v in got.items():
            launches[k] += v
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    emit(card, phase="ckpt", ok=not errors, errors=errors, **parts,
         launches=launches, seconds=time.perf_counter() - t0)
    return not errors, launches


# ------------------------------------------------------------------ ResNet


def _ceil(a, b):
    return -(-a // b)


def rn_block_shapes(image):
    """The distinct (H, Cin, F1, stride, project) of ResNet-50's 16
    bottleneck blocks at `image` (after the stride-2 stem and pool): 8,
    each stage's first block and then its identity blocks."""
    h, cin, out = _ceil(_ceil(image, 2), 2), 64, []
    for filters, blocks, first in RN_STAGES:
        for bi in range(blocks):
            stride = first if bi == 0 else 1
            key = (h, cin, filters, stride, bi == 0)
            if key not in out:
                out.append(key)
            h, cin = _ceil(h, stride), 4 * filters
    return out


def rn_block_case(torch, dev, dtype_name, b, shape, train, seed, int8=False):
    """(label, kernel fn, plain fn, plain-in-f32 fn, bytes, ops, extra)
    for one bottleneck block. The plain-in-f32 fn runs the plain version on
    the same inputs widened to f32 (bf16 values are exact in f32): the
    precision of the TPU body, which keeps its intermediates in f32, and of
    the kernel. `extra`: the convolutions' operations (`conv_ops`), the
    bytes this design moves at least (`design_bytes`: the bound's bytes
    plus each f32 intermediate, a, h, c and the projection, written once
    and read once) and `cudnn`, a fn (bf16, not int8) that runs the block's
    convolutions alone, channels_last, each on the one before's output: a
    reference point for the kernel's convolutions, not a library call for
    the block's function."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import bottleneck_block as bb

    h, cin, f1, stride, project = shape
    f3 = 4 * f1
    dt = getattr(torch, dtype_name)
    es = torch.tensor([], dtype=dt).element_size()
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*sh, scale=1.0, shift=0.0):
        return (torch.randn(sh, generator=g, device=dev) * scale
                + shift).to(dt)

    names = ("a", "b", "c") + (("proj",) if project else ())
    dims = {"a": (1, 1, cin, f1), "b": (3, 3, f1, f1), "c": (1, 1, f1, f3),
            "proj": (1, 1, cin, f3)}
    x = rnd(b, h, h, cin)
    params, state = {}, {}
    for n in names:
        kh, kw, ci, f = dims[n]
        w = torch.randn(dims[n], generator=g, device=dev) * (
            2.0 / (kh * kw * ci)) ** 0.5
        if int8:
            scale = w.abs().reshape(-1, f).amax(0) / 127.0
            params[f"W_{n}"] = torch.round(w / scale).to(torch.int8)
            params[f"W_{n}__scale"] = scale
        else:
            params[f"W_{n}"] = w.to(dt)
        params[f"gamma_{n}"] = rnd(f, scale=0.2, shift=1.0)
        params[f"beta_{n}"] = rnd(f, scale=0.1)
        state[f"mean_{n}"] = torch.randn(f, generator=g, device=dev) * 0.1
        state[f"var_{n}"] = torch.rand(f, generator=g, device=dev) + 0.5
    plain_params = params
    if int8:
        plain_params = {k: (bb._dequant(a, params[k + "__scale"], dt)
                            if a.dtype == torch.int8 else a)
                        for k, a in params.items()}
    flat = [plain_params[f"{k}_{n}"] for n in names
            for k in ("W", "gamma", "beta")]
    kw = dict(stride=(stride, stride), project=project, eps=1e-5,
              activation="relu", train=train)

    def kern():
        y, st = bb.bottleneck_forward(x, params, state, **kw)
        return [y] + ([st[k] for k in bb.stat_keys(project)] if train else [])

    def plain(x=x, flat=flat):
        if train:
            y, st = bb.bottleneck_train_plain(
                x, *flat, stride=(stride, stride), eps=1e-5, act="relu")
            return [y, *st]
        return [bb.bottleneck_infer_plain(x, *flat, stats=state,
                                          stride=(stride, stride), eps=1e-5,
                                          act="relu")]

    def plain_f32():
        return plain(x.float(), [a.float() for a in flat])

    ho = _ceil(h, stride)
    m = b * ho * ho
    w_elems = cin * f1 + 9 * f1 * f1 + f1 * f3 + (cin * f3 if project else 0)
    n_bn = 2 * f1 + f3 + (f3 if project else 0)  # BatchNorm channels
    # x and y once; the weights (int8 with f32 scales); gamma and beta at
    # x's dtype; the f32 statistics, written (train) or read (inference).
    nbytes = ((b * h * h * cin + m * f3) * es
              + w_elems * (1 if int8 else es) + (n_bn * 4 if int8 else 0)
              + n_bn * 2 * es + n_bn * 2 * 4)
    # The convolutions' multiply-adds; ~5 operations per normalized
    # element, 2 per output (add, act), 3 per element of the statistics.
    ops = (2 * m * w_elems + 5 * m * n_bn + 2 * m * f3
           + (3 * m * n_bn if train else 0))
    label = (f"B={b} H={h} Cin={cin} F1={f1} s={stride} "
             f"{'proj' if project else 'identity'}"
             + (" int8" if int8 else ""))
    cudnn = None
    if dtype_name == "bfloat16" and not int8:
        xc = x.permute(0, 3, 1, 2)  # NHWC storage: channels_last already
        wc = {n: params[f"W_{n}"].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last) for n in names}

        def cudnn():
            a = F.conv2d(xc, wc["a"], stride=stride)
            c = F.conv2d(F.conv2d(a, wc["b"], padding=1), wc["c"])
            return [c] + ([F.conv2d(xc, wc["proj"], stride=stride)]
                          if project else [])
    inter = m * (2 * f1 + f3 + (f3 if project else 0)) * 4
    return label, kern, plain, plain_f32, nbytes, ops, dict(
        conv_ops=2 * m * w_elems, design_bytes=nbytes + 2 * inter,
        cudnn=cudnn)


def rn_bn_cases(torch, dev, dtype_name, b):
    """BatchNorm apply at T1's stem (relu) and its widest BatchNorms
    (identity: the library yardstick F.batch_norm applies)."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import norm_act

    dt = getattr(torch, dtype_name)
    es = torch.tensor([], dtype=dt).element_size()
    g = torch.Generator(device=dev).manual_seed(31)
    cases = []
    for label, rows, ch, act in (
            (f"stem [{b}*112*112,64] relu", b * 112 * 112, 64, "relu"),
            (f"s0 c_bn [{b}*56*56,256]", b * 56 * 56, 256, "identity"),
            (f"s3 c_bn [{b}*7*7,2048]", b * 7 * 7, 2048, "identity")):
        x = (torch.randn(rows, ch, generator=g, device=dev) * 2 + 0.5).to(dt)
        m = (torch.randn(ch, generator=g, device=dev) * 0.3).to(dt)
        v = (torch.rand(ch, generator=g, device=dev) + 0.2).to(dt)
        ga = (torch.rand(ch, generator=g, device=dev) + 0.5).to(dt)
        be = torch.randn(ch, generator=g, device=dev).to(dt)
        lib = None
        if act == "identity":
            stats = [a.float() for a in (m, v, ga, be)]

            def lib(x=x, stats=stats):
                return F.batch_norm(x, stats[0], stats[1], stats[2],
                                    stats[3], training=False, eps=1e-5)
        cases.append((
            "batchnorm_norm_act", label,
            lambda x=x, m=m, v=v, ga=ga, be=be, act=act:
                norm_act.batchnorm_norm_act(x, m, v, ga, be, 1e-5, act),
            lambda x=x, m=m, v=v, ga=ga, be=be, act=act:
                norm_act.batchnorm_plain(x, m, v, ga, be, 1e-5, act),
            lib, 2 * rows * ch * es + 4 * ch * es, 6 * rows * ch))
    return cases


def _safe_lib_ms(torch, lib, **reps):
    """A yardstick call that the installed PyTorch refuses is recorded as
    such: it is no part of the port."""
    try:
        return _lib_ms(torch, lib, **reps) + (None,)
    except RuntimeError as e:
        return None, None, f"{type(e).__name__}: {e}"[:200]


def phase_resnet_kernels(card, torch, dev, t1_batch):
    """BatchNorm apply is held to its plain version at the path's dtype.
    A bottleneck block in bf16 is held to its plain version run in f32 on
    the same inputs (`plain_f32`): the kernel, like the TPU body, keeps
    every intermediate in f32 and rounds y once, where the plain version at
    bf16 rounds each conv output and each statistic to bf16; the distance
    to that one is printed beside (`max_abs_err_vs_plain_at_dtype`). Each
    block row names the form its call took (`variant`: every bf16 block
    but the int8 one on the tensor cores, or the row fails), its
    convolutions' rate over its device time (`conv_tflop_s`) and, as a
    reference point, the device time of cuDNN's bf16 channels_last
    convolutions of the same block alone."""
    from deeplearning4j_tpu_torch import kernels

    rows = []
    for dtype in ("bfloat16", "float32"):
        cases = [c + (None, None) for c in rn_bn_cases(torch, dev, dtype,
                                                        t1_batch)]
        blocks = [("bottleneck_train", RN_PATHS["t2"][2], shape, True, 40 + i,
                   False) for i, shape in enumerate(rn_block_shapes(64))]
        blocks += [("bottleneck_infer", INFER_B, shape, False, 50 + i, False)
                   for i, shape in enumerate(rn_block_shapes(224))]
        if dtype == "bfloat16":
            blocks.append(("bottleneck_infer", INFER_B,
                           rn_block_shapes(224)[2], False, 60, True))
            # The smallest /predict bucket: I1's stem and 8 blocks at B=1.
            cases += [c + (None, None)
                      for c in rn_bn_cases(torch, dev, dtype, 1)[:1]]
            blocks += [("bottleneck_infer", 1, shape, False, 80 + i, False)
                       for i, shape in enumerate(rn_block_shapes(224))]
        for name, b, shape, train, seed, int8 in blocks:
            label, kern, plain, plain_f32, nb, ops, extra = rn_block_case(
                torch, dev, dtype, b, shape, train, seed, int8=int8)
            extra["form"] = ("wgmma" if dtype == "bfloat16" and not int8
                             else "cuda_cores")
            cases.append((name, label, kern, plain, None, nb, ops,
                          plain_f32 if dtype == "bfloat16" else None, extra))
        for (name, shape, kern, plain, lib, nbytes, ops, plain_f32,
             extra) in cases:
            kernels.reset_counts()
            got = kern()
            forms = kernels.counts()["variants"].get(name)
            want = plain()
            torch.cuda.synchronize()
            err_dtype, ok = compare(got, want, dtype, RN_TOL)
            err = err_dtype
            if plain_f32 is not None:
                ref = plain_f32()
                torch.cuda.synchronize()
                err, ok = compare(got, ref, dtype, RN_TOL)
                del ref
            del got, want
            bound_ms, bound_by = bound(nbytes, ops, dtype)
            lib_ms, lib_dev_ms, lib_error = _safe_lib_ms(torch, lib)
            block = name.startswith("bottleneck")
            reps = dict(reps=10, warmup=2) if block else {}
            rows.append({
                "name": name, "dtype": dtype, "shape": shape,
                "max_abs_err": err,
                "held_to": ("plain version in f32 on the same inputs"
                            if plain_f32 is not None else
                            f"plain version in {dtype}"),
                "max_abs_err_vs_plain_at_dtype": err_dtype,
                "tolerance": f"rtol=atol={RN_TOL[dtype]}", "ok": ok,
                "ms": time_ms(kern, **reps), "plain_ms": time_ms(plain, **reps),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms, "library_error": lib_error,
                "device_ms": device_ms(torch, kern, 5 if block else 20),
                "plain_device_ms": device_ms(torch, plain,
                                             5 if block else 20),
                "library_device_ms": lib_dev_ms,
                "cuda_launches_per_call": (
                    {"bottleneck_train": 9 if "proj" in shape else 7,
                     "bottleneck_infer": 5 if "proj" in shape else 4}
                    .get(name, 1))})
            if extra is not None:
                expected, cudnn = extra["form"], extra["cudnn"]
                variant = next((k for k, n in forms.items() if n), None)
                dev_ms = rows[-1]["device_ms"]
                rows[-1].update(
                    variant=variant, expected_variant=expected,
                    conv_tflop_s=(extra["conv_ops"] / dev_ms / 1e9 if dev_ms
                                  else "not measured"),
                    design_bytes=extra["design_bytes"],
                    design_byte_floor_ms=(extra["design_bytes"]
                                          / PEAK_BYTES_S * 1e3),
                    cudnn_convs_alone_device_ms=(
                        device_ms(torch, cudnn, 5) if cudnn else None),
                    cudnn_convs_alone_note=(
                        "cuDNN bf16 channels_last convolutions of the same "
                        "block, the convolutions alone (no BatchNorm, "
                        "statistics or tail): a reference point, not this "
                        "row's library column"))
                if forms != {k: int(k == expected)
                             for k in ("wgmma", "cuda_cores")}:
                    rows[-1]["ok"] = False
                    rows[-1]["form_error"] = (f"block launches by form "
                                              f"{forms}, expected one "
                                              f"{expected}")
            emit(card, phase="resnet_kernels", **rows[-1])
        del cases
        torch.cuda.empty_cache()
    return rows


def rn_batches(torch, dev, image, b, n, seed):
    """n learnable batches on the card: each image is its class's template
    (seeded noise images) plus noise at half its scale; one-hot f32 labels
    over the 1000 outputs, drawn from a seeded RN_LEARN_CLASSES of them.
    From random weights at lr 0.1 the reference's own score rises and
    swings over the first 13 steps on labels spread over all 1000 classes;
    over 10 classes, 13 steps show it fall. Made in bulk on the device."""
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet

    g = torch.Generator(device=dev).manual_seed(seed)
    classes = torch.randperm(RN_CLASSES, generator=g,
                             device=dev)[:RN_LEARN_CLASSES]
    templates = torch.randn(RN_LEARN_CLASSES, image, image, 3, generator=g,
                            device=dev)
    eye = torch.eye(RN_CLASSES, device=dev)
    out = []
    for _ in range(n):
        pick = torch.randint(0, RN_LEARN_CLASSES, (b,), generator=g,
                             device=dev)
        x = templates[pick] + 0.5 * torch.randn(b, image, image, 3,
                                                generator=g, device=dev)
        out.append(MultiDataSet([x], [eye[classes[pick]]]))
    return out


def _rn_net(torch, dev, path, **init):
    from deeplearning4j_tpu_torch.models import resnet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    image, fused, _ = RN_PATHS[path]
    conf = resnet.resnet50(n_classes=RN_CLASSES, image=image,
                           dtype="bfloat16", fused_blocks=fused)
    return ComputationGraph(conf, device=dev).init(**init)


def phase_resnet_train(card, torch, kernels, dev, path):
    """`path` "t1" or "t2": 3 warm-up and 10 timed `fit` steps over 2
    batches; B halves while a step does not fit the card (the cut is
    printed)."""
    image, fused, batch = RN_PATHS[path]
    cuts = []
    while True:
        net = _rn_net(torch, dev, path)
        batches = rn_batches(torch, dev, image, batch, 2, 71)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        scores, wall = [], []
        try:
            for i in range(RN_WARMUP + RN_TIMED):
                t0 = time.perf_counter()
                net.fit(batches[i % 2])
                scores.append(net.score_value)  # syncs the step
                wall.append((time.perf_counter() - t0) * 1e3)
            break
        except torch.cuda.OutOfMemoryError as e:
            if batch <= 8:
                raise
            cuts.append(f"B={batch} did not fit: {str(e)[:160]}")
            del net, batches
            torch.cuda.empty_cache()
            batch //= 2
    counts = kernels.counts()
    steps = RN_WARMUP + RN_TIMED
    errors, want = _launch_errors(counts, RN_LAUNCHES[path], steps)
    errors += _variant_errors(counts, {
        n: want[n] for n in RN_BLOCK_FORMS.get(path, ())})
    if not all(np.isfinite(scores)):
        errors.append(f"non-finite score: {scores}")
    last3 = float(np.mean(scores[-3:]))
    if not last3 < scores[0]:
        errors.append(f"scores did not fall: first {scores[0]}, mean of the "
                      f"last 3 {last3}")
    timed = wall[RN_WARMUP:]
    ms = statistics.mean(timed)
    emit(card, phase="resnet_train", path=path, ok=not errors, errors=errors,
         model=f"resnet50 classes={RN_CLASSES} image={image} "
               f"fused_blocks={fused} mixed_bfloat16 Nesterovs lr 0.1",
         batch=batch, batch_cuts=cuts, steps=steps, scores=scores,
         first_score=scores[0], last3_mean=last3, ms_per_step=ms,
         ms_per_step_median=statistics.median(timed), ms_per_step_all=wall,
         samples_per_s=batch / ms * 1e3,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         launches=counts["launches"], expected_launches=want,
         plain_calls=counts["plain_calls"],
         block_forms={n: counts["variants"][n] for n in RN_BLOCK_FORMS.get(
             path, ())})
    return not errors, counts["launches"], net, batches, batch


def phase_resnet_infer(card, torch, kernels, path, net, x):
    """3 warm-up and 10 timed `output` calls at B=32 (each ends in the
    host copy of the probabilities)."""
    kernels.reset_counts()
    wall, outs = [], []
    for _ in range(RN_WARMUP + RN_TIMED):
        t0 = time.perf_counter()
        outs.append(net.output(x)[0])
        wall.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.counts()
    calls = RN_WARMUP + RN_TIMED
    errors, want = _launch_errors(counts, RN_LAUNCHES[path], calls)
    errors += _variant_errors(counts, {
        n: want[n] for n in RN_BLOCK_FORMS.get(path, ())})
    out = outs[-1]
    if out.shape != (INFER_B, RN_CLASSES) or not np.isfinite(out).all():
        errors.append(f"output {out.shape}, finite {np.isfinite(out).all()}")
    elif np.abs(out.sum(-1) - 1).max() > 1e-3:
        errors.append("probabilities do not sum to 1")
    if not all(np.array_equal(o, out) for o in outs):
        errors.append("repeated calls on the same input differ")
    timed = wall[RN_WARMUP:]
    ms = statistics.mean(timed)
    emit(card, phase="resnet_infer", path=path, ok=not errors, errors=errors,
         batch=INFER_B, image=RN_PATHS[path][0], fused=RN_PATHS[path][1],
         calls=calls, ms_per_call=ms, ms_per_call_median=statistics.median(
             timed), ms_per_call_all=wall, images_per_s=INFER_B / ms * 1e3,
         launches=counts["launches"], expected_launches=want,
         plain_calls=counts["plain_calls"],
         block_forms={n: counts["variants"][n] for n in RN_BLOCK_FORMS.get(
             path, ())})
    return not errors, counts["launches"]


def _v_errors(got, want):
    """Per layer vertex with params: max |v_got - v_want| over max
    |v_want| (Nesterovs' v after one step is -lr * grad)."""
    out = {}
    for name, st in want.opt_state.items():
        if not st["v"]:
            continue
        ref = max(float(a.abs().max()) for a in st["v"].values())
        err = max(float((got.opt_state[name]["v"][k].cpu() - a).abs().max())
                  for k, a in st["v"].items())
        out[name] = err / ref if ref else float("inf")
    return out


def phase_resnet_parity(card, torch, dev):
    """f32, B=16, 64x64: the same seeded params on the card and on the CPU,
    for the per-layer and the fused graph: one `output`, one `fit` step,
    and the same step on the CPU in float64 as the reference for the
    gradients.

    A full-depth ResNet step from random weights is ill-conditioned in
    f32: the BatchNorm batch statistics (single-pass, mean(x^2) - mean^2,
    as the reference computes them) of deep features that are nearly alike
    across the batch lose most of their digits, and the backward carries
    that into every layer's gradient, so any two f32 implementations
    disagree by more than 4e-2 of a vertex's largest gradient somewhere.
    So each vertex's Nesterovs v (-lr * grad after one step) is measured
    against the f64 step's, over the largest |v| there, for the card and
    for the CPU's f32 step (the rounding floor): the card's median over
    the vertices may not exceed twice the CPU's (plus 1e-3), nor its
    largest max(4e-2, twice the CPU's largest). A cut gradient is off by
    about 1. B=16 and not 4: at B=4 the floor itself is tens of percent."""
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models import resnet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    rng = np.random.RandomState(81)
    b = RN_PARITY_B
    x = rng.randn(b, 64, 64, 3).astype(np.float32)
    y = np.eye(RN_CLASSES, dtype=np.float32)[rng.randint(0, RN_CLASSES, b)]
    t0 = time.perf_counter()
    errors, res = [], {}
    for fused in (False, True):
        def conf(dtype):
            return resnet.resnet50(n_classes=RN_CLASSES, image=64, dtype=dtype,
                                   fused_blocks=fused)

        cpu = ComputationGraph(conf("float32"), device="cpu").init()
        params = {v: {k: a.detach() for k, a in p.items()}
                  for v, p in cpu.params_tree.items()}
        card_net = ComputationGraph(conf("float32"), device=dev).init(
            params=params)
        cpu64 = ComputationGraph(conf("float64"), device="cpu").init(
            params=params)
        prob_diff = float(np.abs(card_net.output(x)[0]
                                 - cpu.output(x)[0]).max())
        for net in (cpu, card_net, cpu64):
            net.fit(MultiDataSet([x], [y]))
        score_rel = (abs(card_net.score_value - cpu.score_value)
                     / abs(cpu.score_value))
        stat_excess = max(
            float(((card_net.state[v][k].cpu() - a).abs()
                   - (1e-3 + 1e-3 * a.abs())).max())
            for v, s in cpu.state.items() for k, a in s.items())
        card_err = _v_errors(card_net, cpu64)
        cpu_err = _v_errors(cpu, cpu64)
        med_card = statistics.median(card_err.values())
        med_cpu = statistics.median(cpu_err.values())
        worst_card, worst_cpu = max(card_err.values()), max(cpu_err.values())
        form = "fused" if fused else "unfused"
        if prob_diff > 1e-3:
            errors.append(f"{form}: output differs by {prob_diff}")
        if score_rel > 1e-3:
            errors.append(f"{form}: scores {card_net.score_value} (card) vs "
                          f"{cpu.score_value} (CPU)")
        if stat_excess > 0:
            errors.append(f"{form}: running stats beyond rtol=atol=1e-3 by "
                          f"{stat_excess}")
        if med_card > 2 * med_cpu + 1e-3:
            errors.append(f"{form}: the card's median Nesterovs v error "
                          f"against the f64 step, {med_card}, exceeds twice "
                          f"the CPU f32 step's, {med_cpu}")
        if worst_card > max(4e-2, 2 * worst_cpu):
            errors.append(f"{form}: the card's largest Nesterovs v error "
                          f"against the f64 step, {worst_card}, exceeds "
                          f"max(4e-2, twice the CPU f32 step's {worst_cpu})")
        res[form] = {
            "max_abs_prob_diff": prob_diff,
            "score_card": card_net.score_value, "score_cpu": cpu.score_value,
            "score_cpu_f64": cpu64.score_value, "score_rel_diff": score_rel,
            "running_stat_excess_over_tol": stat_excess,
            "vertices": len(card_err),
            "card_v_err_vs_f64_median": med_card,
            "cpu_f32_v_err_vs_f64_median": med_cpu,
            "card_v_err_vs_f64_worst": worst_card,
            "card_v_err_vs_f64_worst_vertex": max(card_err,
                                                  key=card_err.get),
            "cpu_f32_v_err_vs_f64_worst": worst_cpu,
            "card_v_within_4e-2_of_f64": sum(e <= 4e-2
                                             for e in card_err.values()),
            "card_v_err_vs_cpu_f32_worst": max(
                _v_errors(card_net, cpu).values())}
    emit(card, phase="resnet_parity", ok=not errors, errors=errors, batch=b,
         image=64, seconds=time.perf_counter() - t0, **res)
    return not errors


# ------------------------------------------------------------ long context


def long_kernel_cases(torch, dev, dtype_name, t, heads):
    """Rows 4 and 7 at [1, t, heads, 64], causal, in the tuple form of
    `kernel_cases` (a library pair is timed as the first call less the
    second: SDPA's backward is forward + backward less the forward), each
    with the resident kernel of the same function (rows 5 and 6, one block
    per 64-row tile) last: what the streamed schedule changes."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    dt = getattr(torch, dtype_name)
    es = torch.tensor([], dtype=dt).element_size()
    g = torch.Generator(device=dev).manual_seed(t)
    dh = D_MODEL // HEADS
    q, k, v, do = (torch.randn(1, t, heads, dh, generator=g,
                               device=dev).to(dt) for _ in range(4))
    if not fa.streamed(q):
        raise AssertionError(f"T={t} {dtype_name} is under the resident "
                             "limit: the streamed rows would not run")
    scale = dh ** -0.5
    n, rows = t * heads * dh, heads * t
    pairs = heads * t * (t + 1) // 2            # (q, k) pairs, causal half
    shape = f"[1,{t},{heads},{dh}] causal"
    qh, kh, vh, doh = (a.transpose(1, 2).contiguous() for a in (q, k, v, do))
    qg, kg, vg = (a.detach().requires_grad_(True) for a in (qh, kh, vh))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), doh)

    o, lse = fa.flash_stream_fwd_plain(q, k, v, True, scale)
    bwd = (q, k, v, do, lse, fa._drow(o, do), True, scale)
    del o
    return [
        ("flash_attention_stream", shape,
         lambda: fa.flash_attention_stream(q, k, v, True, scale),
         lambda: fa.flash_stream_fwd_plain(q, k, v, True, scale),
         lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True),
         4 * n * es + 4 * rows, 4 * dh * pairs,
         lambda: fa.flash_attention_fwd_lse(q, k, v, True, scale)),
        ("flash_attention_bwd_dq_stream", shape,
         lambda: fa.flash_attention_bwd_dq_stream(*bwd),
         lambda: fa.flash_stream_bwd_dq_plain(*bwd),
         (sdpa_fwd_bwd, sdpa_fwd), 5 * n * es + 8 * rows, 6 * dh * pairs,
         lambda: fa.flash_attention_bwd_dq(*bwd)),
        ("flash_attention_bwd_dkv_stream", shape,
         lambda: fa.flash_attention_bwd_dkv_stream(*bwd),
         lambda: fa.flash_stream_bwd_dkv_plain(*bwd),
         (sdpa_fwd_bwd, sdpa_fwd), 6 * n * es + 8 * rows, 8 * dh * pairs,
         lambda: fa.flash_attention_bwd_dkv(*bwd)),
    ]


FLASH_FORWARDS = ("flash_attention", "flash_attention_fwd_lse",
                  "flash_attention_stream")


def flash_compare(name, got, want, dtype):
    """A flash row (3-7) against its plain version: o, dq, dk, dv at
    TOL[dtype]; a forward's o also row by row at ROW_TOL[dtype] and its lse
    (f32), where it has one, at LSE_TOL; dq, dk and dv row by row at
    BWD_ROW_TOL[dtype] over the ROW_FLOOR'd norm, dq from row 1 (a causal
    row 0 is ~0). Returns the largest elementwise error, whether all
    held, and the largest row error."""
    if name not in FLASH_FORWARDS:
        err, ok = compare(got, want, dtype)
        got, want = (got, want) if isinstance(got, tuple) else \
            ((got[:, 1:],), (want[:, 1:],))
        rows = [compare_rows(g, w, dtype, BWD_ROW_TOL, ROW_FLOOR)
                for g, w in zip(got, want)]
        return (err, ok and all(r_ok for _, r_ok in rows),
                max(e for e, _ in rows))
    if not isinstance(got, tuple):  # row 3: o alone
        got, want = (got,), (want,)
    err_o, ok_o = compare(got[0], want[0], dtype)
    err_r, ok_r = compare_rows(got[0], want[0], dtype)
    err_l, ok_l = compare(got[1], want[1], dtype, {dtype: LSE_TOL}) \
        if len(got) > 1 else (0.0, True)
    return max(err_o, err_l), ok_o and ok_r and ok_l, err_r


def flash_tolerance(name, dtype):
    if name not in FLASH_FORWARDS:
        return (f"rtol=atol={TOL[dtype]}, rows {BWD_ROW_TOL[dtype]} over "
                f"max(norm, {ROW_FLOOR} x median)")
    lse = f", lse {LSE_TOL}" if name != "flash_attention" else ""
    return f"rtol=atol={TOL[dtype]}, rows {ROW_TOL[dtype]}{lse}"


def phase_long_kernels(card, torch, dev):
    """Rows 4 and 7 at the slice's shape ([1, 32768, 8, 64], causal) in
    bf16 and f32, against their plain versions on the card (o, dq, dk, dv
    at rtol = atol = 4e-2 in bf16 and 1e-4 in f32 with TF32 off; the lse
    at 1e-4; row 4's o also row by row at ROW_TOL), timed beside the plain
    version, the bound and the library call; the same at ragged T (12,345
    in f32, 24,577 in bf16). Each row 4 names the form of its unit kernel
    (`fa.stream_fwd_variant`). Then row 13: row 4 over the triangular and
    the rectangular list at B*H = 4 (bf16, inputs randn * 0.5 as
    `bench.py:1089`): each o summed, the rectangle's o against the
    triangle's at 4e-2 and row by row at ROW_TOL, its lse at LSE_TOL, and
    the two times.

    Times here are CUDA events only. torch.profiler, asked for a few of
    these ~100 ms calls alone, returned none or some of their kernels on
    an H100, with or without a 0.5 s pause inside the profile, while it
    returned every kernel of the traced long-context step: the rows'
    kernel times come from the trace phase."""
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    rows = []
    for dtype, t in (("bfloat16", LONG_T), ("float32", LONG_T),
                     ("float32", RAGGED_T), ("bfloat16", RAGGED_BF16_T)):
        for name, shape, kern, plain, lib, nbytes, ops, resident in \
                long_kernel_cases(torch, dev, dtype, t, HEADS):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err, ok, row_err = flash_compare(name, got, want, dtype)
            extra = {}
            if name == "flash_attention_bwd_dq_stream":
                # Row 0, held elementwise only: its largest error over the
                # heads, absolute and over the row gate's floor.
                e0 = float((got[:, 0].float() - want[:, 0].float())
                           .norm(dim=-1).max())
                floor = ROW_FLOOR * float(want.float().norm(dim=-1).median())
                extra = {"row0_abs_err": e0, "row0_err_over_floor": e0 / floor}
            del got, want
            bound_ms, bound_by = bound(nbytes, ops, dtype)
            lib_ms, lib_dev_ms, lib_error = _safe_lib_ms(torch, lib,
                                                         **LONG_REPS)
            rows.append({
                "name": name, "dtype": dtype, "shape": shape,
                "max_abs_err": err,
                "tolerance": flash_tolerance(name, dtype),
                "ok": ok, "ms": time_ms(kern, **LONG_REPS),
                "plain_ms": time_ms(plain, **LONG_REPS),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms, "library_error": lib_error,
                "resident_ms": time_ms(resident, **LONG_REPS),
                "resident_variant": fa.resident_variant(
                    getattr(torch, dtype), D_MODEL // HEADS),
                "device_ms": None, "library_device_ms": lib_dev_ms,
                "workspace_bytes": fa.stream_workspace_bytes(
                    1, t, HEADS, D_MODEL // HEADS)})
            rows[-1].update(max_row_rel_err=row_err, **extra)
            rows[-1]["variant"] = fa.flash_variant(getattr(torch, dtype),
                                                   D_MODEL // HEADS)
            emit(card, phase="long_kernels", **rows[-1])
        torch.cuda.empty_cache()

    dh = D_MODEL // HEADS
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v = ((torch.randn(1, LONG_T, ROW13_HEADS, dh, generator=g,
                            device=dev) * 0.5).to(torch.bfloat16)
               for _ in range(3))

    def stream_sum(pairs):
        return fa.flash_attention_stream(q, k, v, True, with_lse=False,
                                         pairs=pairs).float().sum()

    # The rectangle's units above the diagonal must weigh exactly 0: its o
    # against the triangle's elementwise and row by row, its lse at
    # LSE_TOL; and o without the lse (the timed form) equal to o with it.
    tri, tri_lse = fa.flash_attention_stream(q, k, v, True)
    rect, rect_lse = fa.flash_attention_stream(q, k, v, True,
                                               pairs="rectangle")
    rect_only = fa.flash_attention_stream(q, k, v, True, with_lse=False,
                                          pairs="rectangle")
    torch.cuda.synchronize()
    err, ok = compare(rect, tri, "bfloat16")
    row_err, row_ok = compare_rows(rect, tri, "bfloat16")
    lse_err, lse_ok = compare(rect_lse, tri_lse, "bfloat16",
                              {"bfloat16": LSE_TOL})
    same = bool(torch.equal(rect_only, rect))
    ok = ok and row_ok and lse_ok and same
    del tri, rect, tri_lse, rect_lse, rect_only
    tri_ms = time_ms(lambda: stream_sum("triangle"), **LONG_REPS)
    rect_ms = time_ms(lambda: stream_sum("rectangle"), **LONG_REPS)
    tri_pairs = ROW13_HEADS * LONG_T * (LONG_T + 1) // 2
    nbytes = 4 * ROW13_HEADS * LONG_T * dh * 2
    row13 = {
        "name": "stream_sum", "kernel": "flash_attention_stream",
        "dtype": "bfloat16", "shape": f"[1,{LONG_T},{ROW13_HEADS},{dh}] "
        "causal, triangular vs rectangular list",
        "max_abs_err_rect_vs_tri": err,
        "max_row_rel_err_rect_vs_tri": row_err,
        "max_abs_err_lse_rect_vs_tri": lse_err,
        "o_without_lse_equal": same,
        "tolerance": (f"rtol=atol={TOL['bfloat16']}, rows "
                      f"{ROW_TOL['bfloat16']}, lse {LSE_TOL}"),
        "ok": ok, "tri_ms": tri_ms, "rect_ms": rect_ms,
        "rect_over_tri": rect_ms / tri_ms,
        "tri_bound_ms": bound(nbytes, 4 * dh * tri_pairs, "bfloat16")[0],
        "rect_bound_ms": bound(nbytes, 4 * dh * ROW13_HEADS * LONG_T ** 2,
                               "bfloat16")[0]}
    emit(card, phase="long_kernels", **row13)
    return rows, row13


def _variant_errors(counts, launches):
    """Errors unless every launch of each kernel in `launches` ({name: n};
    a flash row in bf16 at D = 64, a bottleneck row of a fused path) took
    the tensor-core form."""
    errors = []
    for name, n in launches.items():
        want = {"wgmma": n, "cuda_cores": 0}
        got = counts["variants"][name]
        if got != want:
            errors.append(f"{name} launches by form {got} != expected "
                          f"{want}")
    return errors


def _long_conf(dtype):
    from deeplearning4j_tpu_torch.models import zoo

    return zoo.transformer_lm(VOCAB, t=LONG_T, d_model=D_MODEL,
                              n_heads=HEADS, n_blocks=BLOCKS, dtype=dtype)


def _long_batches(torch, dev, seed, n):
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet

    return [MultiDataSet([torch.as_tensor(x, device=dev)],
                         [torch.as_tensor(y, device=dev)])
            for x, y in lm_batches(seed, LONG_B, LONG_T, n)]


def phase_long_train(card, torch, kernels, dev):
    """`transformer_lm` (V=8192, d=512, 8 heads, 4 blocks, bf16 compute)
    trained with `ComputationGraph.fit` at B=1, T=32,768: 2 warm-up and 5
    timed steps over 2 seeded batches; per step exactly 4 streamed
    forwards (all on the tensor-core form), 4 dq, 4 dk/dv, 9 LayerNorm and
    1 update launch, none of rows 3, 5 and 6, 0 plain calls."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    net = ComputationGraph(_long_conf("bfloat16"), device=dev).init()
    batches = _long_batches(torch, dev, 43, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    scores, wall = [], []
    for i in range(LONG_WARMUP + LONG_TIMED):
        t0 = time.perf_counter()
        net.fit(batches[i % 2])
        scores.append(net.score_value)  # reads the loss: syncs the step
        wall.append((time.perf_counter() - t0) * 1e3)
    steps = LONG_WARMUP + LONG_TIMED
    counts = kernels.counts()
    errors, want = _launch_errors(counts, LONG_LAUNCHES, steps)
    errors += _variant_errors(counts, {name: BLOCKS * steps
                                       for name in STREAM_UNITS})
    if not all(np.isfinite(scores)):
        errors.append(f"non-finite score: {scores}")
    last3 = float(np.mean(scores[-3:]))
    if not last3 < scores[0]:
        errors.append(f"scores did not fall: first {scores[0]}, mean of the "
                      f"last 3 {last3}")
    timed = wall[LONG_WARMUP:]
    ms = statistics.mean(timed)
    tokens = LONG_B * LONG_T
    emit(card, phase="long_train", ok=not errors, errors=errors,
         model=f"transformer_lm V={VOCAB} T={LONG_T} d={D_MODEL} "
               f"heads={HEADS} blocks={BLOCKS} mixed_bfloat16 Adam",
         params=sum(a.numel() for p in net.params_tree.values()
                    for a in p.values()),
         batch=LONG_B, tokens_per_step=tokens, steps=steps, scores=scores,
         first_score=scores[0], last3_mean=last3, ms_per_step=ms,
         ms_per_step_median=statistics.median(timed), ms_per_step_all=wall,
         tokens_per_s=tokens / ms * 1e3,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         launches=counts["launches"], expected_launches=want,
         variants=counts["variants"], plain_calls=counts["plain_calls"])
    return not errors, counts["launches"], net, batches


def phase_long_output(card, torch, kernels, net, x):
    """3 `output` calls of the trained net at B=1, T=32,768 (each ends in
    the host copy of [1, 32768, 8192] f32 probabilities): per call exactly
    4 streamed forwards, all on the tensor-core form, and 9 LayerNorms, 0
    plain calls."""
    calls = 3
    kernels.reset_counts()
    wall, outs = [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        outs.append(net.output(x)[0])
        wall.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.counts()
    errors, want = _launch_errors(
        counts, {"layernorm_norm_act": 2 * BLOCKS + 1,
                 "flash_attention_stream": BLOCKS}, calls)
    errors += _variant_errors(counts,
                              {"flash_attention_stream": BLOCKS * calls})
    out = outs[-1]
    if out.shape != (LONG_B, LONG_T, VOCAB) or not np.isfinite(out).all():
        errors.append(f"output {out.shape}, finite {np.isfinite(out).all()}")
    elif np.abs(out.sum(-1) - 1).max() > 1e-2:
        errors.append("probabilities do not sum to 1")
    if not all(np.array_equal(o, out) for o in outs):
        errors.append("repeated calls on the same input differ")
    emit(card, phase="long_output", ok=not errors, errors=errors,
         batch=LONG_B, seq_len=LONG_T, calls=calls,
         ms_per_call=statistics.mean(wall[1:]), ms_per_call_all=wall,
         tokens_per_s=LONG_B * LONG_T / statistics.mean(wall[1:]) * 1e3,
         launches=counts["launches"], expected_launches=want,
         variants=counts["variants"], plain_calls=counts["plain_calls"])
    return not errors, counts["launches"]


def phase_long_parity(card, torch, kernels, dev):
    """One f32 `fit` step at B=1, T=32,768 from the same seeded params on
    the card: through the streamed rows 4 and 7, and through the resident
    rows 5 and 6 with the port's `_RESIDENT_KV_LIMIT` raised for that one
    step (restored after, as the JAX package's tests patch theirs,
    tests/test_flash_attention.py:62). Scores within 1e-4 relative.

    Adam's m (0.1 * grad after one step) per layer vertex, over the
    resident run's largest |m| there, within max(1e-3, twice the step's
    rounding floor). The floor is what the same streamed step moves when
    only the order of its partial sums changes (units of 32 and of 16
    tiles instead of 64; the kernels are deterministic, so a repeat moves
    nothing): at this T the relu layers and the sums over 32,768 tokens
    carry f32 rounding to ~2e-3 of a vertex's largest m in the embeddings
    and the first FFN layers (measured on an H100). A cut or mis-scaled
    gradient is off by far more."""
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    conf = _long_conf("float32")
    batch, = _long_batches(torch, dev, 47, 1)
    t0 = time.perf_counter()
    params = {v: {k: a.detach().clone() for k, a in p.items()}
              for v, p in ComputationGraph(conf, device=dev).init()
              .params_tree.items()}

    def step(**patch):
        net = ComputationGraph(conf, device=dev).init(params={
            v: {k: a.clone() for k, a in p.items()}
            for v, p in params.items()})
        saved = {k: getattr(fa, k) for k in patch}
        for k, val in patch.items():
            setattr(fa, k, val)
        try:
            kernels.reset_counts()
            net.fit(batch)
            return net, kernels.counts()["launches"]
        finally:
            for k, val in saved.items():
                setattr(fa, k, val)

    streamed, c_stream = step()
    resident, c_res = step(_RESIDENT_KV_LIMIT=1 << 62)
    floor = {}
    for units in (32, 16):
        other, _ = step(_UNIT_TILES=units)
        for v, e in _m_errors(other, streamed).items():
            floor[v] = max(floor.get(v, 0.0), e)
        del other
    errors = []
    names = {"streamed": ("flash_attention_stream",
                          "flash_attention_bwd_dq_stream",
                          "flash_attention_bwd_dkv_stream"),
             "resident": ("flash_attention_fwd_lse", "flash_attention_bwd_dq",
                          "flash_attention_bwd_dkv")}
    for run, c, other in (("streamed", c_stream, "resident"),
                          ("resident", c_res, "streamed")):
        if [c[n] for n in names[run]] != [BLOCKS] * 3 or any(
                c[n] for n in names[other]):
            errors.append(f"{run} step launches {c}")
    rel = (abs(streamed.score_value - resident.score_value)
           / abs(resident.score_value))
    m_err = _m_errors(streamed, resident)
    over = {v: e for v, e in m_err.items() if e > max(1e-3, 2 * floor[v])}
    if rel > 1e-4:
        errors.append(f"scores {streamed.score_value} (streamed) vs "
                      f"{resident.score_value} (resident)")
    if over:
        errors.append(f"Adam m differs beyond max(1e-3, twice the floor): "
                      f"{over}")
    emit(card, phase="long_parity", ok=not errors, errors=errors,
         batch=LONG_B, seq_len=LONG_T, dtype="float32",
         score_streamed=streamed.score_value,
         score_resident=resident.score_value, score_rel_diff=rel,
         m_err_over_max=m_err, rounding_floor=floor,
         worst_m_err=max(m_err.values()),
         worst_over_floor=max(e / max(1e-3, 2 * floor[v])
                              for v, e in m_err.items()),
         seconds=time.perf_counter() - t0)
    return not errors


def _http(url, route, body=None, timeout=SERVE_TIMEOUT_S):
    """(status, headers, parsed JSON or text) of a GET, or of a POST of
    `body`; an HTTP error status is returned, not raised."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + route, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, headers, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        code, headers, raw = e.code, e.headers, e.read()
    ctype = headers.get("Content-Type", "")
    return code, headers, (json.loads(raw) if "json" in ctype
                           else raw.decode())


def _requests_total(doc):
    """{(model, route, outcome): count} from a JSON scrape."""
    fam = doc.get("dl4j_requests_total", {"series": []})
    return {(r["labels"]["model"], r["labels"]["route"],
             r["labels"]["outcome"]): r["value"] for r in fam["series"]}


def _add_counts(total, counts):
    for k, v in counts["launches"].items():
        total[k] = total.get(k, 0) + v


def _lm_expected(stats):
    """An LM scheduler's launches for the work its stats count: 9 LayerNorms
    a forward (target prefill or verify, draft prefill or step), 4 flash
    forwards a prefill (target or draft), 4 paged attentions a verify."""
    fwd = (stats["prefills"] + stats["decode_steps"]
           + stats["draft_prefills"] + stats["draft_steps"])
    return {"layernorm_norm_act": (2 * BLOCKS + 1) * fwd,
            "flash_attention": BLOCKS * (stats["prefills"]
                                         + stats["draft_prefills"]),
            "paged_decode_attention": BLOCKS * stats["decode_steps"]}


def _check_window(counts, want):
    """Errors unless the window's launches are exactly `want` (0 for every
    other kernel, training kernels included) with no plain-version call;
    every flash launch on the tensor-core form."""
    errors, _ = _launch_errors(counts, want, 1)
    errors += _variant_errors(counts, {
        "flash_attention": want.get("flash_attention", 0)})
    return errors


def _serving_traffic(seed):
    """Eight greedy and two sampled /generate bodies (SERVE_GREEDY,
    SERVE_SAMPLED): one prompt of each length, so the two greedy bodies of
    one length (the second) are a prefix-cache hit."""
    rng = np.random.RandomState(seed)
    p = {n: rng.randint(0, VOCAB, n).tolist()
         for n in sorted({n for n, _ in SERVE_GREEDY}
                         | {n for n, _, _ in SERVE_SAMPLED})}
    bodies = [{"prompt_ids": p[n], "n_steps": k, "temperature": 0}
              for n, k in SERVE_GREEDY]
    bodies += [{"prompt_ids": p[n], "n_steps": k, "temperature": 0.8,
                "top_k": 40, "seed": sd} for n, k, sd in SERVE_SAMPLED]
    return bodies


def _send_generates(url, sched, bodies, model):
    """POST every body (the second first, alone until it is prefilled, then
    the rest at once); (ids by index, errors, wall seconds)."""
    results, errors = {}, []

    def send(i):
        code, _, doc = _http(url, "/generate", dict(bodies[i], model=model))
        if code == 200:
            results[i] = doc["ids"]
        else:
            errors.append(f"{model} request {i}: HTTP {code} {doc}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(bodies))]
    threads[1].start()
    while (sched.stats["prefills"] + sched.stats["prefix_hits"] < 1
           and time.perf_counter() - t0 < 120 and not errors):
        time.sleep(0.005)
    for i, th in enumerate(threads):
        if i != 1:
            th.start()
    for th in threads:
        th.join(timeout=SERVE_TIMEOUT_S)
    return results, errors, time.perf_counter() - t0


def _plain_greedy(torch, net, bodies):
    """The greedy bodies through a non-speculative scheduler on the same
    net: (ids, per-request top-1 minus top-2 probability at each generated
    position)."""
    from deeplearning4j_tpu_torch.serving.scheduler import (
        GenerationScheduler)

    sched = GenerationScheduler(net, model_name="lm_non_speculative",
                                slots=SLOTS, kv="paged", page_size=PAGE)
    gaps, real = {}, sched._sample

    def sample(req, probs):
        top = np.sort(np.asarray(probs, np.float64))[-2:]
        gaps.setdefault(tuple(req.prompt), []).append(float(top[1] - top[0]))
        return real(req, probs)

    sched._sample = sample
    sched.start()
    out = {}
    try:
        threads = [threading.Thread(target=lambda i=i, b=b: out.__setitem__(
            i, sched.generate(b["prompt_ids"], b["n_steps"],
                              timeout_s=SERVE_TIMEOUT_S, temperature=0.0)))
                   for i, b in enumerate(bodies)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=SERVE_TIMEOUT_S)
    finally:
        sched.stop()
    return out, gaps


def _spec_against_plain(bodies, spec, plain, gaps):
    """Per greedy request: the first generated position where the
    speculative ids leave the non-speculative ones, and the first where
    the latter's top-two probabilities lie within SPEC_TIE; an error where
    the ids part before such a near-tie."""
    rows, errors = [], []
    for i, b in enumerate(bodies):
        n0 = len(b["prompt_ids"])
        got, want = spec.get(i), plain.get(i)
        if got is None or want is None:
            errors.append(f"request {i}: no ids to compare")
            continue
        tie = next((j for j, g in enumerate(gaps[tuple(b["prompt_ids"])])
                    if g < SPEC_TIE), None)
        diff = next((j for j, (a, c) in enumerate(zip(got[n0:], want[n0:]))
                     if a != c), None)
        rows.append({"request": i, "first_difference": diff,
                     "first_near_tie": tie,
                     "min_top2_gap": min(gaps[tuple(b["prompt_ids"])])})
        if diff is not None and (tie is None or diff < tie):
            errors.append(f"request {i}: speculative ids leave the "
                          f"non-speculative ones at {diff}, before any "
                          f"near-tie ({tie})")
    return rows, errors


def phase_serving(card, torch, kernels, dev, cg, t2_net, lenet_net):
    """The serving tier on the card, from disk (see the docstring, phase
    serving): (a) warmup, (b) /predict, (c) /generate, (d) drain, (e) the
    scrape."""
    from deeplearning4j_tpu_torch.checkpoint import store
    from deeplearning4j_tpu_torch.checkpoint.manager import CheckpointManager
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.serving import InferenceServer
    from deeplearning4j_tpu_torch.serving import metrics as serving_metrics
    from deeplearning4j_tpu_torch.util import model_serializer

    t_phase = time.perf_counter()
    errors, out, total = [], {}, {}
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    os.makedirs(SERVE_DIR)
    paths = {"lm": os.path.join(SERVE_DIR, "lm"),
             "resnet": os.path.join(SERVE_DIR, "resnet"),
             "lenet": os.path.join(SERVE_DIR, "lenet.zip")}
    t0 = time.perf_counter()
    # The serving LM's seeded weights with the output projection scaled by
    # SERVE_LOGIT_SCALE, saved as a manager root, and its twin draft.
    params = {v: {k: a.detach().clone() for k, a in p.items()}
              for v, p in cg.params_tree.items()}
    params["out"]["W"].mul_(SERVE_LOGIT_SCALE)
    lm_net = ComputationGraph(cg.conf, device=dev).init(params=params)
    CheckpointManager(paths["lm"], async_save=False, device=dev).save(lm_net)
    del lm_net
    i1 = _rn_net(torch, dev, "i1", params={
        v: {k: a.detach() for k, a in p.items()}
        for v, p in t2_net.params_tree.items()}, state=t2_net.state)
    store.save_checkpoint(i1, paths["resnet"])
    del i1
    model_serializer.save_model(lenet_net, paths["lenet"])
    twin = ComputationGraph(cg.conf, device=dev).init(params=params)
    out["write_s"] = time.perf_counter() - t0
    server = InferenceServer.from_checkpoint(
        paths["lm"], device=dev, warmup=True, kv_cache="paged",
        kv_page_size=PAGE, decode_slots=SLOTS, draft=twin, spec_k=SPEC_K,
        default_model="lm")
    server.add_model("resnet", path=paths["resnet"])
    server.add_model("lenet", path=paths["lenet"])
    out["load_s"] = time.perf_counter() - t0 - out["write_s"]
    try:
        # (a) Warmup: the port opens at once; /healthz reads "warming" and
        # /predict answers 503 + Retry-After until every model is warm.
        kernels.reset_counts()
        t0 = time.perf_counter()
        server.start()
        code, _, health = _http(server.url, "/healthz")
        x1 = np.zeros((1, 28, 28, 1), np.float32).tolist()
        pcode, pheaders, _ = _http(server.url, "/predict",
                                   {"data": x1, "model": "lenet"})
        if health.get("status") != "warming":
            errors.append(f"/healthz during warmup: {health}")
        if pcode != 503 or pheaders.get("Retry-After") != "1":
            errors.append(f"/predict during warmup: HTTP {pcode}, "
                          f"Retry-After {pheaders.get('Retry-After')}")
        server.wait_ready(timeout=SERVE_TIMEOUT_S)
        out["warmup_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernels.counts()
        _add_counts(total, counts)
        lm = server.get(None)
        sched = lm.scheduler
        nb = len(lm.batcher.buckets)
        np_ = len(sched.prompt_buckets)
        rn_buckets = len(server.get("resnet").batcher.buckets)
        # The LM's batch buckets (a forward each), its prompt buckets
        # (target and draft prefills), one step, the SPEC_K verify widths
        # and the draft's step; ResNet's batch buckets.
        want = {"layernorm_norm_act": (2 * BLOCKS + 1) * (
                    nb + 2 * np_ + 1 + SPEC_K + 1),
                "flash_attention": BLOCKS * (nb + 2 * np_),
                "paged_decode_attention": BLOCKS * (1 + SPEC_K),
                "bottleneck_infer": 16 * rn_buckets,
                "batchnorm_norm_act": rn_buckets}
        errors += [f"warmup: {e}" for e in _check_window(counts, want)]
        health = _http(server.url, "/healthz")[2]
        if health != {"status": "ready", "models": {
                "lm": "ready", "resnet": "ready", "lenet": "ready"}}:
            errors.append(f"/healthz after warmup: {health}")
        out["warmup_launches"] = counts["launches"]
        before = _requests_total(_http(
            server.url, "/metrics?format=json&names=dl4j_requests_total")[2])
        sent = {}

        # (b) /predict: ResNet-50 (I1) and LeNet, each response row by row
        # against `output` of the same rows at B = 32 on the card.
        def reference(net, x):
            rows = []
            for i in range(0, len(x), INFER_B):
                chunk = x[i:i + INFER_B]
                pad = np.zeros((INFER_B - len(chunk),) + x.shape[1:],
                               np.float32)
                rows.append(_first(net.output(np.concatenate([chunk, pad])))
                            [:len(chunk)])
            return np.concatenate(rows)

        predict, refs = [], {}
        for model, rows_list, x, dtype in (
                ("resnet", SERVE_RN_ROWS, np.random.RandomState(21).randn(
                    max(SERVE_RN_ROWS), RN_PATHS["i1"][0], RN_PATHS["i1"][0],
                    3).astype(np.float32),
                 "bfloat16"),
                ("lenet", SERVE_LENET_ROWS, np.random.RandomState(22).rand(
                    max(SERVE_LENET_ROWS), 28, 28, 1).astype(np.float32),
                 "float32")):
            served = server.get(model)
            ref = reference(served.net, x)
            refs[model] = (x, ref)
            per_batch = ({"bottleneck_infer": 16, "batchnorm_norm_act": 1}
                         if model == "resnet" else {})
            for n in rows_list:
                http = model == "lenet" or n in SERVE_RN_HTTP_ROWS
                row = {"model": model, "rows": n}
                # The checked call (over HTTP where `http`), then a second,
                # warm one in process, timed.
                for call in ("checked", "timed"):
                    b0 = served.batcher.stats["batches"]
                    kernels.reset_counts()
                    t0 = time.perf_counter()
                    if http and call == "checked":
                        code, _, doc = _http(server.url, "/predict", {
                            "data": x[:n].tolist(), "model": model})
                        got = (np.asarray(doc["predictions"], np.float32)
                               if code == 200 else None)
                        if code != 200:
                            errors.append(f"/predict {model} {n}: HTTP "
                                          f"{code} {doc}")
                    else:
                        got = server.predict(x[:n], model=model)
                    ms = (time.perf_counter() - t0) * 1e3
                    counts = kernels.counts()
                    _add_counts(total, counts)
                    sent[(model, "predict", "ok")] = sent.get(
                        (model, "predict", "ok"), 0) + int(got is not None)
                    batches = served.batcher.stats["batches"] - b0
                    want = {k: v * batches for k, v in per_batch.items()}
                    errors += [f"/predict {model} {n}: {e}"
                               for e in _launch_errors(counts, want, 1)[0]]
                    err, ok = (None, False) if got is None else compare(
                        torch.as_tensor(got), torch.as_tensor(ref[:n]),
                        dtype, RN_TOL)
                    if not ok:
                        errors.append(f"/predict {model} {n} ({call}): rows "
                                      f"differ from output ({err})")
                    if call == "checked":
                        row.update(max_abs_err=err, ok=ok, batches=batches,
                                   padded_to=[served.batcher._bucket_for(
                                       min(INFER_B, n - i))
                                       for i in range(0, n, INFER_B)])
                        if http:
                            row["http_ms"] = ms
                    else:
                        row["ms"] = ms
                predict.append(row)
        out["predict"] = predict

        # (c) /generate: eight greedy and two sampled requests at once,
        # while ResNet-50 answers /predict in process: the batcher's thread
        # (rows 12, 2) and the decode thread (rows 1, 3, 8) launch on one
        # card at the same time.
        bodies = _serving_traffic(31)
        rn = server.get("resnet")
        x_rn, ref_rn = refs["resnet"]
        side = []

        def predict_alongside():
            for n in SERVE_RN_ROWS:
                side.append((n, server.predict(x_rn[:n], model="resnet")))

        kernels.reset_counts()
        stats0, b0 = dict(sched.stats), rn.batcher.stats["batches"]
        along = threading.Thread(target=predict_alongside)
        along.start()
        results, gen_errors, wall = _send_generates(server.url, sched,
                                                    bodies, "lm")
        along.join(timeout=SERVE_TIMEOUT_S)
        torch.cuda.synchronize()
        counts = kernels.counts()
        _add_counts(total, counts)
        errors += gen_errors
        stats = {k: sched.stats[k] - stats0[k] for k in stats0}
        rn_batches = rn.batcher.stats["batches"] - b0
        errors += [f"/generate with /predict alongside: {e}" for e in
                   _check_window(counts, dict(
                       _lm_expected(stats), bottleneck_infer=16 * rn_batches,
                       batchnorm_norm_act=rn_batches))]
        if len(side) != len(SERVE_RN_ROWS):
            errors.append(f"/predict alongside /generate answered "
                          f"{len(side)} of {len(SERVE_RN_ROWS)}")
        for n, got in side:
            err, ok = compare(torch.as_tensor(got),
                              torch.as_tensor(ref_rn[:n]), "bfloat16", RN_TOL)
            if not ok:
                errors.append(f"/predict {n} alongside /generate: rows "
                              f"differ from output ({err})")
        sent[("resnet", "predict", "ok")] += len(side)
        if stats["prefix_hits"] < 1:
            errors.append("no prefix-cache hit")
        if results.get(1) != results.get(7):
            errors.append("the prefix-cache hit decoded other ids than the "
                          "fresh prefill of the same greedy prompt")
        for i, b in enumerate(bodies):
            ids = results.get(i)
            if ids is not None and (
                    len(ids) != len(b["prompt_ids"]) + b["n_steps"]
                    or ids[:len(b["prompt_ids"])] != b["prompt_ids"]
                    or not all(0 <= t < VOCAB for t in ids)):
                errors.append(f"request {i}: malformed ids")
        sent[("lm", "generate", "ok")] = len(results)
        greedy = [b for b in bodies if b["temperature"] == 0]
        plain, gaps = _plain_greedy(torch, server.net, greedy)
        spec_rows, spec_errors = _spec_against_plain(greedy, results, plain,
                                                     gaps)
        errors += spec_errors
        acc, rej = stats["spec_accepted"], stats["spec_rejected"]
        if acc <= 0:
            errors.append("the twin draft accepted no token")
        out["generate"] = dict(
            requests=len(bodies), completed=len(results), wall_s=wall,
            stats=stats, launches=counts["launches"],
            expected_launches=_lm_expected(stats),
            tokens_per_s=stats["decode_tokens"] / wall if wall else None,
            acceptance_rate=acc / (acc + rej) if acc + rej else None,
            predict_alongside=dict(requests=len(side), batches=rn_batches),
            speculative_vs_plain=spec_rows,
            decode_step_ms_median=None)

        # (d) The same traffic on a drain-mode scheduler over the same net.
        server.add_model("lm_drain", net=server.net, scheduler_mode="drain",
                         draft=twin, spec_k=SPEC_K)
        dsched = server.get("lm_drain").scheduler
        kernels.reset_counts()
        dresults, d_errors, dwall = _send_generates(server.url, dsched,
                                                    bodies, "lm_drain")
        torch.cuda.synchronize()
        counts = kernels.counts()
        _add_counts(total, counts)
        errors += d_errors
        dstats = dict(dsched.stats)
        errors += [f"drain: {e}" for e in
                   _check_window(counts, _lm_expected(dstats))]
        if dresults != results:
            errors.append("drain-mode ids differ from continuous mode's: "
                          + str([i for i in results
                                 if dresults.get(i) != results[i]]))
        sent[("lm_drain", "generate", "ok")] = len(dresults)
        out["drain"] = dict(completed=len(dresults), wall_s=dwall,
                            stats=dstats, launches=counts["launches"])

        # (e) One scrape.
        code, headers, scrape = _http(server.url, "/metrics")
        missing = [f for f in serving_metrics.FAMILIES
                   if f"# TYPE {f} " not in scrape]
        if code != 200 or missing:
            errors.append(f"/metrics HTTP {code}, families missing: "
                          f"{missing}")
        if ('dl4j_speculative_tokens_total{model="lm",'
                'outcome="accepted"} 0' in scrape):
            errors.append("no accepted speculative token in the scrape")
        names = "dl4j_requests_total,dl4j_serving_ttft_seconds,"\
                "dl4j_serving_decode_step_seconds,dl4j_serving_itl_seconds"
        code, headers, doc = _http(server.url,
                                   f"/metrics?format=json&names={names}")
        if set(doc) != set(names.split(",")):
            errors.append(f"?names= gave the families {sorted(doc)}")
        after = _requests_total(doc)
        delta = {k: after.get(k, 0) - before.get(k, 0)
                 for k in set(after) | set(before)}
        delta = {k: v for k, v in delta.items() if v}
        if delta != sent:
            errors.append(f"dl4j_requests_total moved by {delta}, "
                          f"requests sent {sent}")

        def summary(name, model="lm"):
            return next(r["summary"] for r in doc[name]["series"]
                        if r["labels"]["model"] == model)

        ttft = list(sched.ttft_s)
        out["metrics"] = {
            "ttft_s_exact": {"p50": float(np.percentile(ttft, 50)),
                             "p99": float(np.percentile(ttft, 99))},
            "ttft_s_histogram": summary("dl4j_serving_ttft_seconds"),
            "decode_step_s_histogram": summary(
                "dl4j_serving_decode_step_seconds"),
            "itl_s_histogram": summary("dl4j_serving_itl_seconds"),
            "requests_total_delta": {"|".join(k): v
                                     for k, v in delta.items()}}
        out["generate"]["decode_step_ms_median"] = 1e3 * out["metrics"][
            "decode_step_s_histogram"].get("p50", float("nan"))
        out["generate"]["decode_step_ms_mean"] = (
            1e3 * stats["decode_seconds"] / max(1, stats["decode_steps"]))
    finally:
        server.stop()
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(card, phase="serving", ok=not errors, errors=errors,
         spec_k=SPEC_K, slots=SLOTS, page=PAGE, **out,
         launches=total, plain_calls=kernels.counts()["plain_calls"])
    return not errors, total


# ------------------------------------------------- layers and features masks


def _image_batches(torch, dev, b, n, seed):
    """rn_batches' learnable images at 224 as DataSets (MultiLayerNetwork)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    return [DataSet(m.features[0], m.labels[0])
            for m in rn_batches(torch, dev, LAYERS_IMAGE, b, n, seed)]


def _fit_steps(net, batches, steps, after=None):
    """`steps` synchronized `fit` calls over `batches` in turn: (scores,
    wall ms per call); `after(i)` runs after call i (1-based), outside the
    walls."""
    scores, wall = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        net.fit(batches[i % len(batches)])
        scores.append(net.score_value)  # syncs the step
        wall.append((time.perf_counter() - t0) * 1e3)
        if after is not None:
            after(i + 1)
    return scores, wall


def _step_report(scores, wall, warmup, batch, gate_trajectory=True):
    """Errors and numbers of a training run: scores finite and falling
    (the last 3 average under the first); without `gate_trajectory` only
    the first score's finiteness is gated and the rest reported."""
    errors = []
    finite = int(np.isfinite(scores).sum())
    if not np.isfinite(scores[0]) or (gate_trajectory
                                      and finite < len(scores)):
        errors.append(f"non-finite score: {scores}")
    last3 = float(np.mean(scores[-3:]))
    fell = last3 < scores[0]
    if gate_trajectory and not fell:
        errors.append(f"scores did not fall: first {scores[0]}, mean of the "
                      f"last 3 {last3}")
    timed = wall[warmup:]
    ms = statistics.mean(timed)
    return errors, dict(
        batch=batch, steps=len(scores), scores=scores, first_score=scores[0],
        finite_scores=finite, last3_mean=last3, score_fell=fell,
        ms_per_step=ms,
        ms_per_step_median=statistics.median(timed), ms_per_step_all=wall,
        samples_per_s=batch / ms * 1e3)


def _drop_checks(torch, dev, train_key):
    """Dropout on the card at AlexNet's two dense inputs, retain 0.5, from
    the subkey the engine's next step would take from `train_key`: kept
    share, kept values exactly 1/retain, the same key's mask again, the
    step after's key another mask, the two layers' masks uncorrelated; the
    draw's time."""
    from deeplearning4j_tpu_torch.nn import prng
    from deeplearning4j_tpu_torch.nn.layers import common

    errors, rows, kept = [], [], []
    step_key, after = prng.split(train_key)[::-1]
    next_key = prng.split(after)[1]
    for idx, shape in zip(ALEX_DENSE, ALEX_DROP_SHAPES):
        x = torch.ones(shape, device=dev)
        key = prng.LayerKey(step_key, idx)
        out = common.inverted_dropout(x, 0.5, key, True)
        keep = out != 0
        share = float(keep.float().mean())
        exact = bool((out[keep] == 2.0).all())
        again = torch.equal(common.inverted_dropout(x, 0.5, key, True), out)
        moved = not torch.equal(common.draw_keep(
            prng.LayerKey(next_key, idx), 0.5, shape, x.device), keep)
        rows.append(dict(shape=list(shape), layer=idx, kept_share=share,
                         kept_exactly_1_over_retain=exact,
                         same_key_same_mask=again,
                         next_key_new_mask=moved, on_card=keep.is_cuda,
                         ms=time_ms(lambda: common.inverted_dropout(
                             x, 0.5, key, True))))
        if not (abs(share - 0.5) <= KEEP_TOL and exact and again and moved
                and keep.is_cuda):
            errors.append(f"dropout at {list(shape)}: {rows[-1]}")
        kept.append(keep.float().flatten())
    n = min(k.numel() for k in kept)
    a, b = (k[:n] for k in kept)
    corr = float(((a - a.mean()) * (b - b.mean())).mean()
                 / (a.std() * b.std()))
    if abs(corr) > CORR_TOL:
        errors.append(f"the two layers' masks correlate: {corr}")
    return errors, {"draws": rows, "layer_mask_correlation": corr}


def _lrn_checks(torch, dev):
    """LRN at AlexNet's two shapes on the card against the same function on
    the CPU (f32, 1e-4); its bf16 time on the card."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        LocalResponseNormalization)
    from deeplearning4j_tpu_torch.nn.layers.convolution import lrn_apply

    conf = LocalResponseNormalization()
    errors, rows = [], []
    for i, shape in enumerate(ALEX_LRN_SHAPES):
        x = torch.randn(shape, generator=torch.Generator().manual_seed(i)) * 3
        want, _ = lrn_apply(conf, {}, {}, x)
        got, _ = lrn_apply(conf, {}, {}, x.to(dev))
        err, ok = compare(got.cpu(), want, "float32")
        xb = x.to(dev, torch.bfloat16)
        rows.append(dict(shape=list(shape), max_abs_err=err, ok=ok,
                         tolerance=f"rtol=atol={TOL['float32']}",
                         bf16_ms=time_ms(lambda: lrn_apply(conf, {}, {}, xb))))
        if not ok:
            errors.append(f"LRN at {list(shape)}: card vs CPU {err}")
    return errors, rows


def _alex_parity(torch, dev):
    """AlexNet f32 at B=4: the same params on the card and on the CPU;
    `output` probabilities; one `fit` step with the same keep masks on
    every side (drawn on the CPU, moved to the net's device), its score
    and the Nesterovs state against a float64 CPU step's, as
    phase_resnet_parity holds it."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.layers import common
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    def conf(dtype):
        return zoo.alexnet(n_classes=RN_CLASSES, image=LAYERS_IMAGE,
                           dtype=dtype)

    rng = np.random.RandomState(92)
    b = ALEX_PARITY_B
    x = rng.rand(b, LAYERS_IMAGE, LAYERS_IMAGE, 3).astype(np.float32)
    y = np.eye(RN_CLASSES, dtype=np.float32)[rng.randint(0, RN_CLASSES, b)]
    cpu = MultiLayerNetwork(conf("float32"), device="cpu").init()
    params = {k: {n: a.detach() for n, a in p.items()}
              for k, p in cpu.params_tree.items()}
    card_net = MultiLayerNetwork(conf("float32"), device=dev).init(
        params=params)
    cpu64 = MultiLayerNetwork(conf("float64"), device="cpu").init(
        params=params)
    prob_diff = float(np.abs(card_net.output(x) - cpu.output(x)).max())
    draw = common.draw_keep
    common.draw_keep = (lambda key, retain, shape, device:
                        draw(key, retain, shape, "cpu").to(device))
    try:
        for net in (cpu, card_net, cpu64):
            net.fit(DataSet(x, y))
    finally:
        common.draw_keep = draw
    score_rel = (abs(card_net.score_value - cpu.score_value)
                 / abs(cpu.score_value))
    card_err, cpu_err = _v_errors(card_net, cpu64), _v_errors(cpu, cpu64)
    med_card = statistics.median(card_err.values())
    med_cpu = statistics.median(cpu_err.values())
    worst_card, worst_cpu = max(card_err.values()), max(cpu_err.values())
    errors = []
    if prob_diff > PARITY_TOL:
        errors.append(f"AlexNet output differs by {prob_diff}")
    if score_rel > PARITY_TOL:
        errors.append(f"AlexNet scores {card_net.score_value} (card) vs "
                      f"{cpu.score_value} (CPU)")
    if med_card > 2 * med_cpu + 1e-3:
        errors.append(f"AlexNet: the card's median Nesterovs v error against "
                      f"the f64 step, {med_card}, exceeds twice the CPU f32 "
                      f"step's, {med_cpu}")
    if worst_card > max(4e-2, 2 * worst_cpu):
        errors.append(f"AlexNet: the card's largest Nesterovs v error "
                      f"against the f64 step, {worst_card}, exceeds "
                      f"max(4e-2, twice the CPU f32 step's {worst_cpu})")
    return errors, {
        "batch": b, "max_abs_prob_diff": prob_diff,
        "score_card": card_net.score_value, "score_cpu": cpu.score_value,
        "score_cpu_f64": cpu64.score_value, "score_rel_diff": score_rel,
        "layers_with_params": len(card_err),
        "card_v_err_vs_f64_median": med_card,
        "cpu_f32_v_err_vs_f64_median": med_cpu,
        "card_v_err_vs_f64_worst": worst_card,
        "cpu_f32_v_err_vs_f64_worst": worst_cpu,
        "card_v_err_vs_cpu_f32_worst": max(_v_errors(card_net,
                                                     cpu).values())}


def phase_layers(card, torch, kernels, dev):
    """The rest of the layers on the card: AlexNet trained, its `output`,
    dropout draws, LRN, parity with the CPU, a resume from a checkpoint;
    VGG-16 trained and its `output` (see the module docstring)."""
    from deeplearning4j_tpu_torch.checkpoint.manager import CheckpointManager
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    t_phase = time.perf_counter()
    shutil.rmtree(LAYERS_DIR, ignore_errors=True)
    steps = RN_WARMUP + RN_TIMED
    errors, launches = [], {}

    # (a) AlexNet fit; after step 5 a checkpoint, its key and a train-mode
    # output of a probe batch (outside the walls).
    net = MultiLayerNetwork(zoo.alexnet(
        n_classes=RN_CLASSES, image=LAYERS_IMAGE, dtype="bfloat16"),
        device=dev).init()
    batches = _image_batches(torch, dev, LAYERS_B, 2, 91)
    probe = batches[1].features[:ALEX_PROBE_B]
    mgr = CheckpointManager(LAYERS_DIR, async_save=False, device=dev)
    saved = {}

    def at_step(i):
        if i == ALEX_SAVE_STEP:
            mgr.save(net)
            saved.update(key=net._train_rng.copy(),
                         out=net.output(probe, train=True))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    scores, wall = _fit_steps(net, batches, steps, at_step)
    counts = kernels.counts()
    launches["alexnet_train"] = counts["launches"]
    errs, want = _launch_errors(counts, LAYERS_LAUNCHES, steps)
    e2, alex = _step_report(scores, wall, RN_WARMUP, LAYERS_B)
    errors += errs + e2
    alex.update(max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                launches=counts["launches"], expected_launches=want,
                plain_calls=counts["plain_calls"])

    # (b) `output` at B=128: inference twice bit for bit, train-mode not.
    x = batches[0].features
    kernels.reset_counts()
    t0 = time.perf_counter()
    o1 = net.output(x)
    out_ms = (time.perf_counter() - t0) * 1e3
    o2, o3 = net.output(x), net.output(x, train=True)
    counts = kernels.counts()
    errs, _ = _launch_errors(counts, {}, 0)
    errors += errs
    if o1.shape != (LAYERS_B, RN_CLASSES) or not np.isfinite(o1).all():
        errors.append(f"AlexNet output {o1.shape}, finite "
                      f"{np.isfinite(o1).all()}")
    if not np.array_equal(o1, o2):
        errors.append("AlexNet inference output differs between two calls")
    if np.array_equal(o1, o3):
        errors.append("AlexNet train-mode output equals the inference one")
    alex.update(output_ms=out_ms, output_repeat_equal=np.array_equal(o1, o2),
                train_output_differs=not np.array_equal(o1, o3))

    # (c) dropout draws, (d) LRN, (e) parity, (f) the resume.
    errs, drops = _drop_checks(torch, dev, net._train_rng)
    errors += errs
    errs, lrn = _lrn_checks(torch, dev)
    errors += errs
    errs, parity = _alex_parity(torch, dev)
    errors += errs
    back = mgr.restore()
    key_ok = np.array_equal(back._train_rng, saved["key"])
    out_ok = np.array_equal(back.output(probe, train=True), saved["out"])
    if not (key_ok and out_ok and back.iteration == ALEX_SAVE_STEP):
        errors.append(f"AlexNet resume: key equal {key_ok}, train-mode "
                      f"output equal {out_ok}, iteration {back.iteration}")
    resume = dict(step=ALEX_SAVE_STEP, key_equal=key_ok,
                  train_output_equal_bit_for_bit=out_ok,
                  checkpoint_bytes=sum(
                      os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(LAYERS_DIR) for f in fs))
    del net, back, batches, probe, x, o1, o2, o3
    shutil.rmtree(LAYERS_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # (g) VGG-16: `output` at B=32 from its init, then fit. Its scores past
    # the first are reported, not gated: from the zoo's random relu init at
    # its lr 0.01, the reference's own VGG-16 diverges within a few steps
    # on such batches (PERF.md, PR 17). Then f32 parity with the CPU at
    # B=2.
    vgg = MultiLayerNetwork(zoo.vgg16(n_classes=RN_CLASSES,
                                      dtype="bfloat16"), device=dev).init()
    vb = _image_batches(torch, dev, LAYERS_B, 2, 93)
    xo = vb[0].features[:VGG_OUTPUT_B]
    vgg.output(xo)
    t0 = time.perf_counter()
    out = vgg.output(xo)
    vgg_output_ms = (time.perf_counter() - t0) * 1e3
    if not (out.shape == (VGG_OUTPUT_B, RN_CLASSES) and np.isfinite(out).all()
            and np.abs(out.sum(-1) - 1).max() < 1e-3):
        errors.append(f"VGG-16 output {out.shape} not finite probabilities")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    scores, wall = _fit_steps(vgg, vb, steps)
    counts = kernels.counts()
    launches["vgg16_train"] = counts["launches"]
    errs, want = _launch_errors(counts, LAYERS_LAUNCHES, steps)
    e2, vgg_res = _step_report(scores, wall, RN_WARMUP, LAYERS_B,
                               gate_trajectory=False)
    errors += errs + e2
    vgg_res.update(
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        launches=counts["launches"], expected_launches=want,
        plain_calls=counts["plain_calls"], output_ms=vgg_output_ms,
        output_batch=VGG_OUTPUT_B)
    del vgg, vb, xo
    torch.cuda.empty_cache()
    cpu = MultiLayerNetwork(zoo.vgg16(n_classes=RN_CLASSES, dtype="float32"),
                            device="cpu").init()
    card_net = MultiLayerNetwork(zoo.vgg16(n_classes=RN_CLASSES,
                                           dtype="float32"), device=dev).init(
        params={k: {n: a.detach() for n, a in p.items()}
                for k, p in cpu.params_tree.items()})
    xp = np.random.RandomState(94).rand(VGG_PARITY_B, LAYERS_IMAGE,
                                        LAYERS_IMAGE, 3).astype(np.float32)
    diff = float(np.abs(card_net.output(xp) - cpu.output(xp)).max())
    if diff > PARITY_TOL:
        errors.append(f"VGG-16 f32 output card vs CPU differs by {diff}")
    vgg_res["parity_f32_b2_max_abs_prob_diff"] = diff
    del cpu, card_net
    torch.cuda.empty_cache()
    emit(card, phase="layers", ok=not errors, errors=errors,
         alexnet=dict(model=f"alexnet classes={RN_CLASSES} "
                      f"image={LAYERS_IMAGE} mixed_bfloat16 Nesterovs lr "
                      "0.01, dropout 0.5 (retain)", **alex),
         dropout=drops, lrn=lrn, alexnet_parity=parity,
         alexnet_resume=resume,
         vgg16=dict(model=f"vgg16 classes={RN_CLASSES} mixed_bfloat16 "
                    "Nesterovs lr 0.01", **vgg_res),
         phase_s=time.perf_counter() - t_phase)
    return not errors, launches


def mask_batches(torch, dev, n, seed, ragged=True):
    """n batches of TRAIN_B sequences of int64 ids, padded (id 0) to t =
    CACHE from lengths drawn in [MASK_MIN_T, t] (all t when not `ragged`,
    and then no mask): about half of a sequence's ids are its class's own
    id, the rest uniform over the vocabulary (`examples/text_classifier.py`'s
    class-marker tokens); int32 labels; a [b, t] f32 features mask. Made on
    the device."""
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet

    b, t = TRAIN_B, CACHE
    g = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.arange(t, device=dev)[None, :]
    out = []
    for _ in range(n):
        cls = torch.randint(0, MASK_CLASSES, (b,), generator=g, device=dev)
        lens = (torch.randint(MASK_MIN_T, t + 1, (b,), generator=g,
                              device=dev) if ragged
                else torch.full((b,), t, device=dev))
        ids = torch.randint(0, VOCAB, (b, t), generator=g, device=dev)
        marker = torch.rand(b, t, generator=g, device=dev) < 0.5
        ids = torch.where(marker, cls[:, None], ids)
        real = pos < lens[:, None]
        ids = torch.where(real, ids, 0)
        out.append(MultiDataSet([ids], [cls.int()], features_masks=(
            [real.float()] if ragged else None)))
    return out


def phase_masked(card, torch, kernels, dev):
    """The transformer classifier under features masks on the card: masked
    training, one unmasked step through rows 5 and 6 non-causal, padding
    that does not leak, masked `output` against the CPU, masked
    `evaluate` (see the module docstring)."""
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    t_phase = time.perf_counter()

    def conf(dtype):
        return zoo.transformer_classifier(
            VOCAB, MASK_CLASSES, t=CACHE, d_model=D_MODEL, n_heads=HEADS,
            n_blocks=BLOCKS, dtype=dtype)

    errors, launches = [], {}
    net = ComputationGraph(conf("bfloat16"), device=dev).init()
    batches = mask_batches(torch, dev, 2, 101)
    steps = WARMUP + TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    scores, wall = _fit_steps(net, batches, steps)
    counts = kernels.counts()
    launches["masked_train"] = counts["launches"]
    errs, want = _launch_errors(counts, MASK_LAUNCHES, steps)
    e2, train = _step_report(scores, wall, WARMUP, TRAIN_B)
    errors += errs + e2
    real = float(sum(float(m.features_masks[0].sum()) for m in batches)
                 / len(batches))
    train.update(real_tokens_per_batch=real,
                 real_tokens_per_s=real / train["ms_per_step"] * 1e3,
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                 launches=counts["launches"], expected_launches=want,
                 plain_calls=counts["plain_calls"])

    # An unmasked step (after one to warm its path up): rows 5 and 6
    # non-causal, on the tensor cores.
    full = mask_batches(torch, dev, 1, 103, ragged=False)[0]
    net.fit(full)
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    net.fit(full)
    unmasked_score = net.score_value  # syncs the step
    unmasked_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.counts()
    launches["unmasked_step"] = counts["launches"]
    per_step = {**MASK_LAUNCHES, **{n: BLOCKS for n in TRAIN_FLASH}}
    errs, want_u = _launch_errors(counts, per_step, 1)
    errors += errs + _variant_errors(counts, {n: BLOCKS for n in TRAIN_FLASH})
    if not np.isfinite(unmasked_score):
        errors.append(f"unmasked step score {unmasked_score}")

    # Padding does not leak; masked `evaluate`.
    mds = batches[0]
    ids, mask = mds.features[0], mds.features_masks[0]
    other = torch.where(mask > 0, ids, (ids + 7) % VOCAB)
    out = net.output(ids, features_masks=[mask])[0]
    leak = not np.array_equal(out, net.output(other,
                                              features_masks=[mask])[0])
    if leak or not np.isfinite(out).all():
        errors.append(f"padded ids changed the masked output: {leak}")
    accuracy = net.evaluate(mds).accuracy()
    if not 0.0 <= accuracy <= 1.0:
        errors.append(f"masked evaluate accuracy {accuracy}")
    del net, batches, full, mds, ids, mask, other
    torch.cuda.empty_cache()

    # Masked `output`, f32, B=2, T=256: the card against the CPU.
    cpu = ComputationGraph(conf("float32"), device="cpu").init()
    card_net = ComputationGraph(conf("float32"), device=dev).init(params={
        v: {k: a.detach() for k, a in p.items()}
        for v, p in cpu.params_tree.items()})
    rng = np.random.RandomState(104)
    pids = rng.randint(0, VOCAB, (MASK_PARITY_B, MASK_PARITY_T))
    pmask = np.ones((MASK_PARITY_B, MASK_PARITY_T), np.float32)
    pmask[1, MASK_PARITY_T // 3:] = 0.0
    diff = float(np.abs(card_net.output(pids, features_masks=[pmask])[0]
                        - cpu.output(pids, features_masks=[pmask])[0]).max())
    if diff > PARITY_TOL:
        errors.append(f"masked output card vs CPU differs by {diff}")
    del cpu, card_net
    emit(card, phase="masked", ok=not errors, errors=errors,
         model=f"transformer_classifier V={VOCAB} classes={MASK_CLASSES} "
               f"d={D_MODEL} heads={HEADS} blocks={BLOCKS} mixed_bfloat16 "
               f"Adam; B={TRAIN_B} ragged {MASK_MIN_T}-{CACHE}",
         train=train, unmasked_step=dict(
             ms=unmasked_ms, score=unmasked_score,
             launches=counts["launches"],
             expected_launches=want_u,
             flash_forms={n: counts["variants"][n] for n in TRAIN_FLASH}),
         padding_leaks=leak, evaluate_accuracy=accuracy,
         parity_f32_max_abs_prob_diff=diff,
         phase_s=time.perf_counter() - t_phase)
    return not errors, launches


@contextlib.contextmanager
def cpu_draws(torch):
    """The port's random draws (`nn/layers/common.py`) made the same on
    every device while the block runs: each draws on the CPU from its key
    and moves the draw to the device asked for, so a card step and a CPU
    step see the same noise (restored after)."""
    from deeplearning4j_tpu_torch.nn.layers import common

    was = {k: getattr(common, k) for k in (
        "draw_keep", "draw_uniform", "draw_normal", "draw_bernoulli")}
    common.draw_keep = (lambda key, retain, shape, device:
                        was["draw_keep"](key, retain, shape, "cpu")
                        .to(device))
    common.draw_uniform = (lambda key, lo, hi, shape, dtype, device:
                           was["draw_uniform"](key, lo, hi, shape, dtype,
                                               "cpu").to(device))
    common.draw_normal = (lambda key, shape, dtype, device:
                          was["draw_normal"](key, shape, dtype, "cpu")
                          .to(device))
    common.draw_bernoulli = (lambda key, p, shape, device:
                             was["draw_bernoulli"](
                                 key, p.cpu() if isinstance(p, torch.Tensor)
                                 else p, shape, "cpu").to(device))
    try:
        yield
    finally:
        for k, f in was.items():
            setattr(common, k, f)


@contextlib.contextmanager
def moe_routing(torch):
    """While the block runs, every MoE layer's forward also appends its
    `Routing` (`parallel/expert.py` `route` on the layer's own tokens, the
    router input as the layer sees it without jitter) to the yielded
    list, with the layer's aux loss and its tokens; restored after."""
    from deeplearning4j_tpu_torch.nn import layers as impls
    from deeplearning4j_tpu_torch.parallel import expert

    seen = []
    layer = impls.LAYER_IMPLS["MoELayer"]

    def spy(conf, params, state, x, **kw):
        out, st = layer(conf, params, state, x, **kw)
        tokens = x.reshape(-1, x.shape[-1])
        acc = torch.promote_types(tokens.dtype, torch.float32)
        seen.append((expert.route(params["gate_w"], tokens.to(acc),
                                  capacity_factor=conf.capacity_factor,
                                  top_k=conf.top_k),
                     float(st["_aux_loss"]) / conf.aux_loss_weight, tokens))
        return out, st

    impls.LAYER_IMPLS["MoELayer"] = spy
    try:
        yield seen
    finally:
        impls.LAYER_IMPLS["MoELayer"] = layer


def _routing_report(torch, seen, n_experts):
    """Per MoE layer: aux loss, the assignments each expert kept (first and
    second choices), each expert's first choices, the share of assignments
    dropped, the capacity."""
    rows = []
    for r, aux, _ in seen:
        kept = torch.bincount(r.expert[r.keep], minlength=n_experts)
        rows.append(dict(
            aux_loss=aux, capacity=r.capacity,
            tokens=int(r.expert.shape[1]),
            expert_load_kept=kept.tolist(),
            first_choices=torch.bincount(
                r.expert[0], minlength=n_experts).tolist(),
            dropped_share=1.0 - float(r.keep.float().mean())))
    return rows


def _rel_max(got, want):
    """max |got - want| over max |want|."""
    want = want.detach().float().cpu()
    den = float(want.abs().max()) or 1.0
    return float((got.detach().float().cpu() - want).abs().max()) / den


def _moe_layer_parity(torch, dev, net, name, tokens):
    """The MoE FFN `name` of the trained net alone, at the cell's N = B * T
    tokens, card against CPU on the same inputs: the bf16 tokens it was
    handed in the `output` call (held in f32, as the layer upcasts them),
    its params rounded to bf16 (as the engine casts them) and held in f32,
    one jitter draw made on the card and copied. Expert choices, kept
    slots and drops must be identical (asserted). y (before its bf16
    cast), the aux loss, the gates and the gradients of sum(y * dy) + aux
    are held at MOE_GRAD_TOL of their largest value, except the entries
    downstream of a ReLU kink that the two devices' f32 sums put on either
    side of 0 (a pre-activation within rounding of 0 passes its whole
    gradient on one side and none on the other): the w1 and b1 columns of
    such an expert unit and the x rows of such a token are left out,
    counted and limited to MOE_FLIP_SHARE. Times the layer's forward +
    backward on the card and its six expert matmuls alone."""
    from deeplearning4j_tpu_torch.nn.layers import common
    from deeplearning4j_tpu_torch.nn.prng import LayerKey, prng_key
    from deeplearning4j_tpu_torch.parallel import expert

    conf = net.layer_vertices[name].layer
    x = tokens.float().cpu()
    n = x.shape[0]
    dy = torch.randn(n, D_MODEL, generator=torch.Generator().manual_seed(61))
    names = {"gate_w": "gate_w", "w1": "w1", "b1": "b_1", "w2": "w2",
             "b2": "b_2"}
    p = {k: net.params_tree[name][v].detach().bfloat16().float().cpu()
         for k, v in names.items()}
    key = LayerKey(prng_key(62), 0)
    noise = common.draw_uniform(key, 1.0 - conf.router_jitter,
                                1.0 + conf.router_jitter, x.shape,
                                torch.float32, dev).cpu()

    def run(device):
        px = {k: a.to(device, copy=True).requires_grad_(True)
              for k, a in p.items()}
        xx = x.to(device, copy=True).requires_grad_(True)
        routing = []
        was = common.draw_uniform
        common.draw_uniform = (lambda k, lo, hi, shape, dtype, d:
                               noise.to(d, dtype))
        try:
            y, aux = expert.moe_ffn(
                px, xx, capacity_factor=conf.capacity_factor,
                top_k=conf.top_k, rng=key, jitter_eps=conf.router_jitter,
                return_aux=True, routing=routing)
        finally:
            common.draw_uniform = was
        ((y * dy.to(device)).sum() + aux).backward()
        r = routing[0]
        with torch.no_grad():
            # The first expert matmul's pre-activations, as the FFN forms
            # them (its dispatch, rows past the buffer for the dropped).
            e, c = px["w1"].shape[0], r.capacity
            rows = torch.where(r.keep, r.slot, e * c).reshape(-1)
            xin = xx.new_zeros(e * c + 1, xx.shape[1]).index_copy(
                0, rows, xx.repeat(r.slot.shape[0], 1))[:e * c]
            live = torch.bmm(xin.view(e, c, -1), px["w1"]) + px[
                "b1"][:, None, :] > 0
        return (y, aux, r, xx.grad, {k: a.grad for k, a in px.items()},
                live.cpu())

    card_out, cpu_out = run(dev), run("cpu")
    rc, rp = card_out[2], cpu_out[2]
    same = {f: bool(torch.equal(getattr(rc, f).cpu(), getattr(rp, f)))
            for f in ("expert", "slot", "keep")}
    errors = [f"routing differs card vs CPU: {same}"] if not all(
        same.values()) else []
    flips = card_out[5] != cpu_out[5]                       # [E, C, H]
    unit_ok = ~flips.any(1)                                 # [E, H]
    slot_flip = flips.any(2).reshape(-1)                    # [E * C]
    token_ok = ~(slot_flip[rp.slot] & rp.keep).any(0)       # [N]
    err = {"y": _rel_max(card_out[0], cpu_out[0]),
           "aux": _rel_max(card_out[1], cpu_out[1]),
           "gate": _rel_max(rc.gate, rp.gate),
           "dx": _rel_max(card_out[3].cpu()[token_ok], cpu_out[3][token_ok]),
           "dw1": _rel_max(card_out[4]["w1"].cpu().transpose(1, 2)[unit_ok],
                           cpu_out[4]["w1"].transpose(1, 2)[unit_ok]),
           "db1": _rel_max(card_out[4]["b1"].cpu()[unit_ok],
                           cpu_out[4]["b1"][unit_ok]),
           **{f"d{k}": _rel_max(card_out[4][k], cpu_out[4][k])
              for k in ("gate_w", "w2", "b2")}}
    over = {k: v for k, v in err.items() if not v <= MOE_GRAD_TOL}
    if over:
        errors.append(f"MoE layer card vs CPU beyond {MOE_GRAD_TOL}: {over}")
    kink = dict(flipped_pre_activations=int(flips.sum()),
                pre_activations=flips.numel(),
                units_left_out=int((~unit_ok).sum()),
                units=unit_ok.numel(),
                token_rows_left_out=int((~token_ok).sum()))
    if (kink["units_left_out"] > MOE_FLIP_SHARE * kink["units"]
            or kink["token_rows_left_out"] > MOE_FLIP_SHARE * n):
        errors.append(f"too many ReLU kinks apart: {kink}")
    err_all = {"dx": _rel_max(card_out[3], cpu_out[3]),
               "dw1": _rel_max(card_out[4]["w1"], cpu_out[4]["w1"]),
               "db1": _rel_max(card_out[4]["b1"], cpu_out[4]["b1"])}

    # The layer's forward + backward on the card, and its two expert
    # matmuls (forward and the two gradients of each) alone.
    px = {k: a.to(dev, copy=True).requires_grad_(True)
          for k, a in p.items()}
    xx = x.to(dev, copy=True).requires_grad_(True)
    dyd = dy.to(dev)

    def layer_step():
        y = expert.moe_ffn(px, xx, capacity_factor=conf.capacity_factor,
                           top_k=conf.top_k)
        torch.autograd.grad((y * dyd).sum(), [xx, *px.values()])

    c = rc.capacity
    e, h = p["w1"].shape[0], p["w1"].shape[2]
    a1 = torch.randn(e, c, D_MODEL, device=dev)
    w1, w2 = p["w1"].to(dev), p["w2"].to(dev)

    def matmuls():
        hh = torch.bmm(a1, w1)                      # h = in @ w1
        torch.bmm(hh, w2)                           # out = h @ w2
        dh = torch.bmm(a1, w2.transpose(1, 2))      # d h
        torch.bmm(hh.transpose(1, 2), a1)           # d w2
        torch.bmm(dh, w1.transpose(1, 2))           # d in
        torch.bmm(a1.transpose(1, 2), dh)           # d w1

    step_ms = time_ms(layer_step, reps=10, warmup=2)
    mm_ms = time_ms(matmuls, reps=10, warmup=2)
    flops = 6 * 2 * e * c * D_MODEL * h
    return errors, dict(
        layer=name, tokens=n, capacity=c, routing_identical=same,
        dropped_share=1.0 - float(rp.keep.float().mean()),
        rel_err=err, rel_err_kinks_included=err_all, relu_kinks=kink,
        tolerance=MOE_GRAD_TOL,
        layer_fwd_bwd_ms=step_ms, expert_matmuls_ms=mm_ms,
        expert_matmul_tflop=flops / 1e12,
        expert_matmul_tflop_s=flops / (mm_ms * 1e-3) / 1e12,
        expert_share_of_layer=mm_ms / step_ms)


def _moe_conf(dtype, n_blocks=None, cache=None):
    from deeplearning4j_tpu_torch.models import zoo

    return zoo.transformer_lm(VOCAB, t=CACHE, d_model=D_MODEL, n_heads=HEADS,
                              n_blocks=n_blocks or BLOCKS, moe=True,
                              n_experts=MOE_EXPERTS, dtype=dtype,
                              decode_cache_length=cache)


def phase_moe(card, torch, kernels, dev):
    """The MoE LM on the card (see the module docstring): training at full
    width, the routing it learned, `output`, cached greedy decode against
    the CPU, the MoE layer alone card against CPU, one f32 step card
    against CPU."""
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    t_phase = time.perf_counter()
    errors, launches = [], {}
    net = ComputationGraph(_moe_conf("bfloat16"), device=dev).init()
    batches = [MultiDataSet([torch.as_tensor(x, device=dev)],
                            [torch.as_tensor(y, device=dev)])
               for x, y in lm_batches(17, TRAIN_B, CACHE, 2)]
    steps = WARMUP + MOE_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    scores, wall = _fit_steps(net, batches, steps)
    counts = kernels.counts()
    launches["moe_train"] = counts["launches"]
    errs, want = _launch_errors(counts, MOE_LAUNCHES, steps)
    errors += errs + _variant_errors(counts, {n: BLOCKS * steps
                                              for n in TRAIN_FLASH})
    e2, train = _step_report(scores, wall, WARMUP, TRAIN_B)
    errors += e2
    train.update(tokens_per_step=TRAIN_B * CACHE,
                 tokens_per_s=TRAIN_B * CACHE / train["ms_per_step"] * 1e3,
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                 launches=counts["launches"], expected_launches=want,
                 plain_calls=counts["plain_calls"])
    del train["samples_per_s"]

    # `output` on one batch, each MoE layer's routing recorded.
    x = batches[0].features[0]
    torch.cuda.synchronize()
    kernels.reset_counts()
    with moe_routing(torch) as seen:
        t0 = time.perf_counter()
        probs = net.output(x)[0]
        output_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.counts()
    launches["moe_output"] = counts["launches"]
    errs, want_out = _launch_errors(counts, MOE_OUTPUT_LAUNCHES, 1)
    errors += errs
    with torch.inference_mode():  # the forward alone, no host copy
        forward_ms = time_ms(lambda: net._forward(
            net._compute_copy(), net.state, [x], keep_rnn_state=False),
            reps=5, warmup=1)
    if probs.shape != (TRAIN_B, CACHE, VOCAB) or not np.isfinite(
            probs).all():
        errors.append(f"output {probs.shape}, finite "
                      f"{bool(np.isfinite(probs).all())}")
    routing = _routing_report(torch, seen, MOE_EXPERTS)
    if len(routing) != BLOCKS:
        errors.append(f"{len(routing)} MoE layers routed, not {BLOCKS}")

    # Cached greedy decode: the decode-cache twin of the trained params,
    # the output projection x SERVE_LOGIT_SCALE (so greedy has margins), on
    # the card and on the CPU.
    params = {v: {k: a.detach() * (SERVE_LOGIT_SCALE if v == "out" else 1)
                  for k, a in p.items()}
              for v, p in net.params_tree.items()}
    dec = ComputationGraph(_moe_conf("bfloat16", cache=CACHE),
                           device=dev).init(params=params)
    cpu_dec = ComputationGraph(_moe_conf("bfloat16", cache=CACHE),
                               device="cpu").init(params=params)
    prompt = [int(i) for i in lm_batches(64, 1, MOE_PROMPT, 1)[0][0][0, :, 0]]
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    ids = zoo.generate_lm(dec, prompt, MOE_NEW, window=CACHE,
                          temperature=0.0, use_cache=True)
    decode_s = time.perf_counter() - t0
    counts = kernels.counts()
    launches["moe_decode"] = counts["launches"]
    errs, want_dec = _launch_errors(counts, MOE_DECODE_LAUNCHES, 1)
    errors += errs
    cpu_ids = zoo.generate_lm(cpu_dec, prompt, MOE_NEW, window=CACHE,
                              temperature=0.0, use_cache=True)
    if ids != cpu_ids:
        errors.append(f"greedy ids differ: card {ids[len(prompt):]}, CPU "
                      f"{cpu_ids[len(prompt):]}")
    del dec, cpu_dec, params, probs
    torch.cuda.empty_cache()

    # The layer that dropped the most tokens, alone, card vs CPU.
    worst = max(range(len(routing)),
                key=lambda i: routing[i]["dropped_share"])
    errs, layer = _moe_layer_parity(torch, dev, net, f"ffn{worst}",
                                    seen[worst][2])
    errors += errs
    del net, batches, x, seen
    torch.cuda.empty_cache()
    # One f32 step at 1 block, B=2, card vs CPU (Adam's m and v held as
    # train_parity holds m, at 4e-2 of their largest value).
    (x, y), = lm_batches(63, MOE_PARITY_B, CACHE, 1)
    errs, step = _step_parity(torch, dev, ComputationGraph,
                              _moe_conf("float32", 1),
                              MultiDataSet([x], [y]), 4e-2)
    errors += errs
    emit(card, phase="moe", ok=not errors, errors=errors,
         model=f"transformer_lm(moe=True) V={VOCAB} T={CACHE} d={D_MODEL} "
               f"heads={HEADS} blocks={BLOCKS} experts={MOE_EXPERTS}x"
               f"{4 * D_MODEL} top-2 jitter 1e-2 mixed_bfloat16 Adam",
         train=train, output=dict(ms=output_ms, forward_ms=forward_ms,
                                  launches=launches["moe_output"],
                                  expected_launches=want_out),
         routing_by_layer=routing,
         decode=dict(prompt=len(prompt), new_tokens=MOE_NEW,
                     ids=ids[len(prompt):], cpu_ids=cpu_ids[len(prompt):],
                     seconds=decode_s, launches=launches["moe_decode"],
                     expected_launches=want_dec),
         layer_parity=layer, f32_step_parity=step,
         phase_s=time.perf_counter() - t_phase)
    return not errors, launches


def _pretrain_confs():
    """The pretrain phase's four nets (f32, MNIST), by name: (conf, whether
    its input is flat)."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        NeuralNetConfiguration,
    )

    flat = InputType.feed_forward(784)
    vae = (NeuralNetConfiguration.builder().seed(12345)
           .learning_rate(PRETRAIN_VAE_LR)
           .updater("rmsprop").rms_decay(0.95).weight_init("xavier")
           .l2(1e-4).list()
           .layer(L.VariationalAutoencoder(
               n_out=2, encoder_layer_sizes=(256, 256),
               decoder_layer_sizes=(256, 256), activation="leakyrelu",
               pzx_activation="identity",
               reconstruction_distribution="bernoulli"))
           .pretrain(True).backprop(False).set_input_type(flat).build())
    stack = (NeuralNetConfiguration.builder().seed(123).learning_rate(
        PRETRAIN_STACK_LR).updater("adam").weight_init("xavier").list()
             .layer(L.AutoEncoder(n_out=500, corruption_level=0.3,
                                  activation="sigmoid"))
             .layer(L.RBM(n_out=250, visible_unit="binary",
                          hidden_unit="binary", k=1))
             .layer(L.OutputLayer(n_out=10, activation="softmax",
                                  loss_function="mcxent"))
             .pretrain(True).backprop(True).set_input_type(flat).build())
    center = (NeuralNetConfiguration.builder().seed(123).learning_rate(0.01)
              .updater("nesterovs").momentum(0.9).weight_init("xavier")
              .l2(5e-4).activation("identity").list()
              .layer(L.ConvolutionLayer(kernel_size=(5, 5), n_out=20))
              .layer(L.SubsamplingLayer(pooling_type="max",
                                        kernel_size=(2, 2), stride=(2, 2)))
              .layer(L.ConvolutionLayer(kernel_size=(5, 5), n_out=50))
              .layer(L.SubsamplingLayer(pooling_type="max",
                                        kernel_size=(2, 2), stride=(2, 2)))
              .layer(L.DenseLayer(n_out=500, activation="relu"))
              .layer(L.CenterLossOutputLayer(
                  n_out=10, activation="softmax",
                  loss_function="negativeloglikelihood", alpha=0.1,
                  lambda_=2e-4))
              .set_input_type(InputType.convolutional(28, 28, 1)).build())
    loss = (NeuralNetConfiguration.builder().seed(123).learning_rate(
        PRETRAIN_STACK_LR).updater("adam").weight_init("xavier").list()
            .layer(L.DenseLayer(n_out=256, activation="relu"))
            .layer(L.DenseLayer(n_out=10, activation="identity"))
            .layer(L.LossLayer(activation="softmax", loss_function="mcxent"))
            .set_input_type(flat).build())
    return {"vae": (vae, True), "ae_rbm": (stack, True),
            "lenet_center_loss": (center, False), "mlp_loss_layer": (loss, True)}


def _step_parity(torch, dev, engine, conf, batch, state_tol):
    """One `fit` call of `conf` (pretraining steps included where the conf
    says so) on `batch` with an `engine` class, card against CPU from the
    same params, the draws made on the CPU for both (`cpu_draws`): scores
    within PARITY_TOL relative; every updater state tensor and declared
    state tensor (the centers) within `state_tol` of its largest value;
    and at most MOE_FLIP_SHARE of the params more than 1e-3 lr apart (a
    normalised updater's first step is about lr * sign(g), so a gradient
    that is rounding noise may step the other way)."""
    cpu = engine(conf, device="cpu").init()
    card_net = engine(conf, device=dev).init(params={
        k: {n: a.detach() for n, a in p.items()}
        for k, p in cpu.params_tree.items()})
    before = cpu.params()
    with cpu_draws(torch):
        for net in (cpu, card_net):
            net.fit(batch)
    score_rel = (abs(card_net.score_value - cpu.score_value)
                 / abs(cpu.score_value))
    state_err = {f"{lk}/{f}": max(_rel_max(card_net.opt_state[lk][f][k], a)
                                  for k, a in s.items())
                 for lk, st in cpu.opt_state.items() for f, s in st.items()
                 if s}
    state_err.update({f"{lk}/{k}": _rel_max(card_net.state[lk][k], a)
                      for lk, st in cpu.state.items() for k, a in st.items()})
    lr = float(cpu._global.learning_rate)
    step_diff = np.abs(card_net.params() - cpu.params())
    flip_share = float(np.mean(step_diff > 1e-3 * lr))
    errors = []
    if not score_rel <= PARITY_TOL:
        errors.append(f"first step scores {card_net.score_value} (card) vs "
                      f"{cpu.score_value} (CPU)")
    over = {k: v for k, v in state_err.items() if not v <= state_tol}
    if over:
        errors.append(f"first step state beyond {state_tol}: {over}")
    if flip_share > MOE_FLIP_SHARE:
        errors.append(f"first step: {flip_share} of the params stepped "
                      f"differently (> {MOE_FLIP_SHARE})")
    return errors, dict(
        iterations=card_net.iteration, score_card=card_net.score_value,
        score_cpu=cpu.score_value, score_rel_diff=score_rel,
        state_rel_err=state_err, state_tolerance=state_tol,
        max_param_diff=float(step_diff.max()),
        params_moved=float(np.abs(cpu.params() - before).max()),
        share_of_params_stepping_differently=flip_share, lr=lr)


def phase_pretrain(card, torch, kernels, dev):
    """Layerwise pretraining and the last layers on MNIST (see the module
    docstring): each net's first `fit` call card against CPU, then one
    epoch on the card with its launches counted; the VAE's ELBO, the
    stack's and the LossLayer MLP's accuracy, LeNet's accuracy and its
    moved centers."""
    from deeplearning4j_tpu_torch.datasets.builtin import (
        MnistDataSetIterator,
    )
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import listeners as ls

    t_phase = time.perf_counter()
    errors, launches, report = [], {}, {}
    data = {flat: (MnistDataSetIterator(MNIST_B, train=True, flat=flat),
                   MnistDataSetIterator(MNIST_B, train=False, flat=flat))
            for flat in (True, False)}
    for name, (conf, flat) in _pretrain_confs().items():
        train, test = data[flat]
        first = next(iter(train))
        errs, parity = _step_parity(
            torch, dev, MultiLayerNetwork, conf,
            DataSet(np.asarray(first.features), np.asarray(first.labels)),
            PARITY_TOL)
        errors += [f"{name}: {e}" for e in errs]
        net = MultiLayerNetwork(conf, device=dev).init()
        scores = ls.CollectScoresIterationListener(1)
        net.set_listeners(scores)
        n_pre = sum(type(x).__name__ in ("VariationalAutoencoder",
                                         "AutoEncoder", "RBM")
                    for x in conf.layers)
        steps = MNIST_STEPS * (n_pre + int(conf.backprop))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        t0 = time.perf_counter()
        net.fit(train)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        counts = kernels.counts()
        launches[f"pretrain_{name}"] = counts["launches"]
        errs, want = _launch_errors(counts, {"fused_update": 1}, steps)
        vals = [s for _, s in scores.scores]
        if net.iteration != steps or len(vals) != steps:
            errs.append(f"{net.iteration} iterations, {len(vals)} scores, "
                        f"not {steps}")
        if not all(np.isfinite(vals)):
            errs.append("non-finite score")
        # Each pass (a layer's pretraining, or backprop) must lower its
        # objective, the mean of its last 50 steps under its first 50's;
        # but an RBM's CD-k surrogate (a free-energy gap, no bound of
        # anything) is only reported.
        kinds = [type(x).__name__ for x in conf.layers
                 if type(x).__name__ in ("VariationalAutoencoder",
                                         "AutoEncoder", "RBM")]
        kinds += ["backprop"] if conf.backprop else []
        passes = []
        for i, kind in enumerate(kinds):
            part = vals[i * MNIST_STEPS:(i + 1) * MNIST_STEPS]
            first50, last50 = (float(np.mean(part[:50])),
                               float(np.mean(part[-50:])))
            passes.append(dict(objective=kind, first50_mean=first50,
                               last50_mean=last50))
            if kind != "RBM" and not last50 < first50:
                errs.append(f"{kind} pass: scores did not fall ({first50} "
                            f"-> {last50})")
        row = dict(params=net.num_params(), steps=steps,
                   pretrain_passes=n_pre, backprop=bool(conf.backprop),
                   epoch_s=epoch_s, ms_per_step=epoch_s * 1e3 / steps,
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                   first_score=vals[0], last_score=vals[-1], passes=passes,
                   launches=counts["launches"], expected_launches=want,
                   first_step_parity=parity)
        if conf.backprop:
            row["accuracy"] = net.evaluate(test).accuracy()
        if name == "lenet_center_loss":
            centers = net.state[net.layer_keys[-1]]["centers"]
            row["centers_abs_mean"] = float(centers.abs().mean())
            if not row["accuracy"] >= MNIST_ACCURACY:
                errs.append(f"accuracy {row['accuracy']} < {MNIST_ACCURACY}")
            if not float(centers.abs().max()) > 0:
                errs.append("the centers did not move")
        errors += [f"{name}: {e}" for e in errs]
        report[name] = row
        del net
        torch.cuda.empty_cache()
    emit(card, phase="pretrain", ok=not errors, errors=errors,
         batch=MNIST_B, train_images=MNIST_TRAIN_N, nets=report,
         phase_s=time.perf_counter() - t_phase)
    return not errors, launches


@contextlib.contextmanager
def plain_versions():
    """The serving LM's kernel wrappers swapped for their plain versions
    while the block runs (the long_serve reference only; restored after):
    LayerNorm, the streamed flash forward and the paged decode attention."""
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import norm_act
    from deeplearning4j_tpu_torch.nn.layers import normalization

    saved = (normalization.layernorm_norm_act, fa.flash_attention_stream,
             fa.paged_decode_attention)

    def stream_plain(q, k, v, causal=True, scale=None, *, with_lse=True,
                     pairs=None):
        o, lse = fa.flash_stream_fwd_plain(q, k, v, causal,
                                           fa._default_scale(q, scale),
                                           pairs)
        return (o, lse) if with_lse else o

    normalization.layernorm_norm_act = norm_act.layernorm_plain
    fa.flash_attention_stream = stream_plain
    fa.paged_decode_attention = fa.paged_gather_dense
    try:
        yield
    finally:
        (normalization.layernorm_norm_act, fa.flash_attention_stream,
         fa.paged_decode_attention) = saved


@contextlib.contextmanager
def planted_fault(torch, kernel):
    """A planted fault for the long_serve parity's own check: the first
    block's attention output zeroed in every forward, in the prefill's row
    4 (`kernel="stream"`) or in the decode's row 8 (`"paged"`); the other
    blocks and kernels run as they are. Restored after the block."""
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    attr = {"stream": "flash_attention_stream",
            "paged": "paged_decode_attention"}[kernel]
    saved, calls = getattr(fa, attr), [0]

    def zero_first_block(*args, **kw):
        out = saved(*args, **kw)
        first = calls[0] % BLOCKS == 0
        calls[0] += 1
        if not first:
            return out
        if isinstance(out, tuple):
            return (torch.zeros_like(out[0]),) + tuple(out[1:])
        return torch.zeros_like(out)

    setattr(fa, attr, zero_first_block)
    try:
        yield
    finally:
        setattr(fa, attr, saved)


def logit_rel_err(got, want):
    """||c_got - c_want|| / ||c_want||, c a distribution's log-probabilities
    less their mean (its logits up to a constant): the error relative to
    the logits' spread, which a near-uniform distribution does not hide."""
    def centered(p):
        lp = np.log(np.maximum(np.asarray(p, np.float64), 1e-30))
        return lp - lp.mean()

    g, w = centered(got), centered(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def phase_long_serve(card, torch, kernels, dev):
    """The LM at T = 32,768 behind a paged server (4 slots, pages of 64),
    its output projection times SERVE_LOGIT_SCALE: one prompt of 30,000
    seeded ids, 16 greedy tokens. Then its first-token distribution and
    LONG_PARITY_STEPS decode steps through the kernels against the same
    weights through the plain versions on the card: probabilities within
    4e-2 and logits within LONG_LOGIT_TOL of their spread; and the same
    comparison must fail (above LONG_LOGIT_TOL) with a planted fault, the
    first block's attention zeroed in the prefill (row 4; the first
    distribution) or in the decode (row 8; the 4 steps)."""
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models.zoo import PagedDecodeStepper
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.serving import InferenceServer

    t_phase = time.perf_counter()
    errors, out = [], {}
    conf = zoo.transformer_lm(VOCAB, t=LONG_T, d_model=D_MODEL,
                              n_heads=HEADS, n_blocks=BLOCKS,
                              dtype="bfloat16", decode_cache_length=LONG_T)
    params = {v: {k: a.detach().clone() for k, a in p.items()}
              for v, p in ComputationGraph(conf, device=dev).init()
              .params_tree.items()}
    params["out"]["W"].mul_(SERVE_LOGIT_SCALE)
    net = ComputationGraph(conf, device=dev).init(params=params)
    del params
    prompt = np.random.RandomState(41).randint(0, VOCAB,
                                               LONG_PROMPT).tolist()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = InferenceServer(net, device=dev, kv_cache="paged",
                             kv_page_size=PAGE, decode_slots=SLOTS).start()
    try:
        sched = server.get(None).scheduler
        kernels.reset_counts()
        t0 = time.perf_counter()
        code, _, doc = _http(server.url, "/generate", {
            "prompt_ids": prompt, "n_steps": LONG_NEW, "temperature": 0})
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = kernels.counts()
        stats = dict(sched.stats)
        ttft = list(sched.ttft_s)
        pages = sched.stepper.pool.num_pages
    finally:
        server.stop()
    peak = torch.cuda.max_memory_allocated()
    if code != 200:
        errors.append(f"/generate: HTTP {code} {str(doc)[:300]}")
    else:
        ids = doc["ids"]
        if (len(ids) != LONG_PROMPT + LONG_NEW or ids[:LONG_PROMPT] != prompt
                or not all(0 <= t < VOCAB for t in ids)):
            errors.append("malformed ids")
    steps = stats["decode_steps"]
    # The prefill pads to the 32,768 bucket: row 4 once a block, row 3
    # never; a decode step is row 8 once a block, at cursors past 30,000.
    want = {"layernorm_norm_act": (2 * BLOCKS + 1) * (1 + steps),
            "flash_attention_stream": BLOCKS,
            "paged_decode_attention": BLOCKS * steps}
    errors += _launch_errors(counts, want, 1)[0]
    errors += _variant_errors(counts, {"flash_attention_stream": BLOCKS})
    if steps != LONG_NEW - 1 or stats["prefills"] != 1:
        errors.append(f"scheduler stats {stats}")
    out.update(prompt=LONG_PROMPT, new_tokens=LONG_NEW, wall_s=wall,
               ttft_s=ttft[0] if ttft else None,
               decode_step_ms=1e3 * stats["decode_seconds"] / max(1, steps),
               decode_steps=steps, pool_pages=pages,
               prompt_bucket=LONG_T, launches=counts["launches"],
               expected_launches=want,
               max_memory_allocated_bytes=peak)

    # The same weights through the kernels and through the plain versions,
    # both fed the kernel run's greedy tokens.
    def run(feed):
        st = PagedDecodeStepper(net, SLOTS, page_size=PAGE)
        probs, state, n = st.prefill(prompt, pad_to=LONG_T)
        st.install(0, state, n)
        seq = [probs]
        for j in range(LONG_PARITY_STEPS):
            tok = int(seq[j].argmax()) if feed is None else feed[j]
            seq.append(st.step([tok] + [0] * (SLOTS - 1))[0])
        return seq

    served_launches = counts["launches"]
    seq_kernel = run(None)
    kernels.reset_counts()
    t0 = time.perf_counter()
    with plain_versions():
        seq_plain = run([int(p.argmax()) for p in seq_kernel[:-1]])
    plain_s = time.perf_counter() - t0
    counts = kernels.counts()
    if any(counts["launches"].values()) or not counts["plain_calls"][
            "flash_attention_stream"]:
        errors.append(f"the plain run launched kernels: {counts}")
    diffs = [float(np.abs(a - b).max()) for a, b in zip(seq_kernel,
                                                        seq_plain)]
    logit_errs = [logit_rel_err(a, b) for a, b in zip(seq_kernel, seq_plain)]
    agree = [int(a.argmax()) == int(b.argmax())
             for a, b in zip(seq_kernel, seq_plain)]
    if not (all(np.isfinite(diffs)) and max(diffs) <= 4e-2):
        errors.append(f"kernel and plain probabilities differ: {diffs}")
    if not (all(np.isfinite(logit_errs))
            and max(logit_errs) <= LONG_LOGIT_TOL):
        errors.append(f"kernel and plain logits differ: {logit_errs} "
                      f"(limit {LONG_LOGIT_TOL} of their spread)")
    # The check's own reach: each planted fault must fail it where its
    # kernel decides the distribution (row 4 the prefill's, row 8 the
    # decode steps').
    fault_errs = {}
    for kernel, judged in (("stream", slice(0, 1)),
                           ("paged", slice(1, None))):
        with planted_fault(torch, kernel):
            seq_fault = run([int(p.argmax()) for p in seq_kernel[:-1]])
        fault_errs[kernel] = [logit_rel_err(a, b)
                              for a, b in zip(seq_fault, seq_plain)]
        if not min(fault_errs[kernel][judged]) > LONG_LOGIT_TOL:
            errors.append(f"a planted fault in {kernel} passes the logit "
                          f"check: {fault_errs[kernel]}")
        del seq_fault
    out.update(parity_tolerance=4e-2, max_abs_prob_diff=diffs,
               logit_tolerance=LONG_LOGIT_TOL, logit_rel_err=logit_errs,
               planted_fault_logit_rel_err=fault_errs,
               argmax_agrees=agree, plain_run_s=plain_s,
               phase_s=time.perf_counter() - t_phase)
    del net, seq_kernel, seq_plain
    torch.cuda.empty_cache()
    emit(card, phase="long_serve", ok=not errors, errors=errors, **out)
    return not errors, served_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    try:
        from deeplearning4j_tpu_torch import kernels
        from deeplearning4j_tpu_torch.kernels import _build
        from deeplearning4j_tpu_torch.models import zoo
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    failed = []

    _build.load(force=True)
    b = _build.last_build
    emit(card, phase="build", seconds=b["seconds"], commands=b["commands"],
         ptxas=b["ptxas"])
    emit(card, phase="build",
         tensor_core_ptxas=tensor_core_ptxas(b["ptxas"]))

    train_conf = zoo.transformer_lm(VOCAB, t=CACHE, d_model=D_MODEL,
                                    n_heads=HEADS, n_blocks=BLOCKS,
                                    dtype="bfloat16")
    rows = phase_kernels(card, torch, dev, train_conf)
    if not all(r["ok"] for r in rows):
        failed.append("kernels")
    rn_rows = phase_resnet_kernels(card, torch, dev, RN_PATHS["t1"][2])
    if not all(r["ok"] for r in rn_rows):
        failed.append("resnet_kernels")
    rows += rn_rows

    conf = zoo.transformer_lm(VOCAB, t=CACHE, d_model=D_MODEL, n_heads=HEADS,
                              n_blocks=BLOCKS, dtype="bfloat16",
                              decode_cache_length=CACHE)
    cg = ComputationGraph(conf, device=dev).init()
    ok, serve_launches = phase_serve(card, torch, kernels, cg)
    if not ok:
        failed.append("serve")
    if not phase_parity(card, torch, cg, conf):
        failed.append("parity")
    ok, train_launches, train_net, batches, train_ms = phase_train(
        card, torch, kernels, train_conf, dev)
    if not ok:
        failed.append("train")
    if not phase_train_parity(card, torch, dev):
        failed.append("train_parity")

    path_launches = {"serve": serve_launches, "train": train_launches}
    nets, rn_batch = {}, {}
    for path in ("t1", "t2"):
        ok, path_launches[path], nets[path], rn_batch[path], _ = \
            phase_resnet_train(card, torch, kernels, dev, path)
        if not ok:
            failed.append(f"resnet_train_{path}")
    # I2 is T1's graph; I1 the fused graph at 224 with T2's weights and
    # running statistics (the same shapes at any image size).
    i1_net = _rn_net(torch, dev, "i1", params={
        v: {k: a.detach() for k, a in p.items()}
        for v, p in nets["t2"].params_tree.items()}, state=nets["t2"].state)
    x224 = rn_batch["t1"][0].features[0][:INFER_B]
    for path, net in (("i1", i1_net), ("i2", nets["t1"])):
        ok, path_launches[path] = phase_resnet_infer(card, torch, kernels,
                                                     path, net, x224)
        if not ok:
            failed.append(f"resnet_infer_{path}")
    del i1_net, x224
    if not phase_resnet_parity(card, torch, dev):
        failed.append("resnet_parity")

    rnn_rows = phase_rnn_kernels(card, torch, dev)
    if not all(r["ok"] for r in rnn_rows):
        failed.append("rnn_kernels")
    rows += rnn_rows
    ok, path_launches["rnn_train"], rnn_net, rnn_data, perm = \
        phase_rnn_train(card, torch, kernels, dev)
    if not ok:
        failed.append("rnn_train")
    ok, path_launches["rnn_sample"] = phase_rnn_sample(card, torch, kernels,
                                                       rnn_net, perm)
    if not ok:
        failed.append("rnn_sample")
    if not phase_rnn_parity(card, torch, dev):
        failed.append("rnn_parity")
    mnist = {}
    for model in ("lenet", "mlp"):
        ok, path_launches[f"{model}_train"], mnist[model] = \
            phase_mnist_train(card, torch, kernels, dev, model)
        if not ok:
            failed.append(f"{model}_train")
        if model == "lenet" and not phase_lenet_parity(card, torch, dev,
                                                       mnist[model][0]):
            failed.append("lenet_parity")
    ok, path_launches["dsl"] = phase_dsl(
        card, torch, kernels, dev, nets["t2"], rn_batch["t2"][0],
        *mnist["lenet"])
    if not ok:
        failed.append("dsl")
    ok, path_launches["ckpt"] = phase_ckpt(card, torch, kernels, dev,
                                           train_ms)
    if not ok:
        failed.append("ckpt")
    ok, path_launches["serving"] = phase_serving(
        card, torch, kernels, dev, cg, nets["t2"], mnist["lenet"][0])
    if not ok:
        failed.append("serving")
    ok, path_launches["long_serve"] = phase_long_serve(card, torch, kernels,
                                                       dev)
    if not ok:
        failed.append("long_serve")

    long_rows, row13 = phase_long_kernels(card, torch, dev)
    if not (all(r["ok"] for r in long_rows) and row13["ok"]):
        failed.append("long_kernels")
    rows += long_rows
    ok, path_launches["long_train"], long_net, long_batches = \
        phase_long_train(card, torch, kernels, dev)
    if not ok:
        failed.append("long_train")
    ok, path_launches["long_output"] = phase_long_output(
        card, torch, kernels, long_net, long_batches[0].features[0])
    if not ok:
        failed.append("long_output")
    if not phase_long_parity(card, torch, kernels, dev):
        failed.append("long_parity")
    ok, layer_launches = phase_layers(card, torch, kernels, dev)
    if not ok:
        failed.append("layers")
    path_launches.update(layer_launches)
    ok, mask_launches = phase_masked(card, torch, kernels, dev)
    if not ok:
        failed.append("masked")
    path_launches.update(mask_launches)
    ok, moe_launches = phase_moe(card, torch, kernels, dev)
    if not ok:
        failed.append("moe")
    path_launches.update(moe_launches)
    ok, pretrain_launches = phase_pretrain(card, torch, kernels, dev)
    if not ok:
        failed.append("pretrain")
    path_launches.update(pretrain_launches)
    trace, ok = phase_trace(card, torch, cg, train_net, batches[0], nets,
                            rn_batch, rnn_net, rnn_data[0], long_net,
                            long_batches[0], mnist)
    if not ok:
        failed.append("trace")

    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    # The kernels line: each kernel at the shape most of its main-path
    # launches have (bf16; the update kernel's state and the char-RNN are
    # f32), with this run's launches on the main paths (each counted from
    # 0: the serve phase, the LM train phase's 23 steps, T1's and T2's 13
    # steps, I1's and I2's 13 calls, the char-RNN's 13 fit calls and its
    # 2 x 200 sampling calls, LeNet's and the MLP's 469 steps each, the
    # dsl, ckpt and serving phases' card windows, the long server's
    # request, the long-context train phase's 7 steps and its 3 `output`
    # calls, AlexNet's and VGG-16's 13 steps each, the classifier's 23
    # masked steps and its counted unmasked step, the MoE LM's 13 steps,
    # its `output` and its cached decode, the four pretrain nets' epochs),
    # summed and by path.
    # Row 10's library call covers the step
    # without peepholes (at the same B and n); row 13 is row 4's kernel
    # over two lists, carried on row 4's entry.
    main_shape = {
        "layernorm_norm_act": f"[4,{D_MODEL}]",
        "batchnorm_norm_act": f"s0 c_bn [{RN_PATHS['t1'][2]}*56*56,256]",
        "bottleneck_train": f"B={RN_PATHS['t2'][2]} H=4 Cin=1024 F1=256 s=1 "
                            "identity",
        "bottleneck_infer": f"B={INFER_B} H=14 Cin=1024 F1=256 s=1 "
                            "identity",
        "lstm_cell": f"B={RNN_B} n={RNN_H} peephole",
        **{name: f"[1,{LONG_T},{HEADS},{D_MODEL // HEADS}] causal"
           for name in LONG_LAUNCHES if name.endswith("_stream")}}
    main_shape["fused_update"] = lm_update_label(lm_update_shapes(train_conf))
    main_dtype = {"fused_update": "float32", "lstm_cell": "float32"}
    attn = trace["long_attention"]
    sdpa_ms = {k: v["device_ms_per_call"] for k, v in attn.items()
               if isinstance(v, dict) and "device_ms_per_call" in v}
    entries = []
    for name, (source, replaces) in KERNEL_INFO.items():
        dtype = main_dtype.get(name, "bfloat16")
        r = next(r for r in rows if r["name"] == name and r["dtype"] == dtype
                 and r["shape"] == main_shape.get(name, r["shape"]))
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c[name] for c in path_launches.values()),
            "launches_by_path": {path: c[name]
                                 for path, c in path_launches.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"], "host_ms": r.get("host_ms"),
            "dtype": dtype,
            "shape": r["shape"], "card": card})
        if name in STREAM_UNITS or name in RESIDENT_ROWS:
            entries[-1]["variant"] = r["variant"]
        if name in RESIDENT_ROWS:
            entries[-1]["tensor_core_source"] = TENSOR_CORE_SOURCE
        if name.startswith("bottleneck"):
            entries[-1].update({k: r[k] for k in (
                "variant", "conv_tflop_s", "design_byte_floor_ms",
                "cudnn_convs_alone_device_ms")})
        if name == "flash_attention_stream":
            # Device times from the traced window (unit kernel and merge
            # per launch in an L1 fit step; causal SDPA per call).
            if "row4" in attn:
                entries[-1]["device_ms"] = \
                    attn["row4_in_fit_step"]["device_ms_per_launch"]
                entries[-1]["library_device_ms"] = sdpa_ms["sdpa_causal"]
                row13.update(
                    tri_device_ms=sdpa_ms["row13_triangle"],
                    rect_device_ms=sdpa_ms["row13_rectangle"])
            entries[-1]["row13_stream_sum"] = row13
        elif name in STREAM_UNITS and "row4" in attn:
            # Row 7: its unit kernel per launch in the traced L1 step, and
            # its yardstick, SDPA's backward (forward + backward less the
            # forward), by device time.
            unit = f"stream_{STREAM_UNITS[name]}_" + (
                "wgmma_kernel" if r["variant"] == "wgmma" else "kernel")
            hit = [k for k in trace["long_train_step"]["backward"].get(
                "top", []) if unit in k["kernel"]]
            if hit:
                entries[-1]["device_ms"] = \
                    hit[0]["ms_per_call"] / hit[0]["per_call"]
            entries[-1]["library_device_ms"] = (
                sdpa_ms["sdpa_causal_fwd_bwd"] - sdpa_ms["sdpa_causal"])
        if name == "fused_update":
            # Row 9 at LeNet's update (Nesterovs, one launch a step there).
            lenet = next(r for r in rows if r["name"] == name
                         and r["shape"].startswith("nesterovs"))
            entries[-1]["lenet_nesterovs"] = {k: lenet[k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "device_ms", "host_ms",
                "bound_share_by_device", "library_device_ms")}
        # The serving tier's new shapes: row 8 with the verify's query
        # rows and over the long server's 512 pages a slot; rows 12 and 2
        # at the smallest /predict bucket.
        keep = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "device_ms", "host_ms",
                "bound_share_by_device", "variant")
        new_shape = {
            "paged_decode_attention":
                lambda r: f",{SPEC_K + 1},{HEADS}," in r["shape"]
                or f"pool[{SLOTS * LONG_T // PAGE + 1}," in r["shape"],
            "bottleneck_infer": lambda r: r["shape"].startswith("B=1 "),
            "batchnorm_norm_act": lambda r: r["shape"].startswith(
                "stem [1*")}.get(name)
        if new_shape is not None:
            entries[-1]["serving_shapes"] = [
                {k: r[k] for k in keep if k in r} for r in rows
                if r["name"] == name and r["dtype"] == "bfloat16"
                and new_shape(r)]
        if name in TRAIN_FLASH:
            # The classifier's unmasked step: the same shape non-causal.
            entries[-1]["non_causal_shapes"] = [
                {k: r[k] for k in ("dtype", "max_row_rel_err", *keep)
                 if k in r} for r in rows
                if r["name"] == name and r["shape"].endswith("non-causal")]
        if name == "lstm_cell":
            # Per launch in the traced char-RNN fit call (R1's shape).
            hit = [k for k in trace["rnn_fit_call"]["forward"].get("top", [])
                   if "lstm_cell" in k["kernel"]]
            if hit:
                entries[-1]["device_ms_in_fit_call"] = (
                    hit[0]["ms_per_call"] / hit[0]["per_call"])
            entries[-1]["library_ms_without_peepholes"] = next(
                r["library_ms"] for r in rows if r["name"] == name
                and r["dtype"] == dtype
                and r["shape"] == f"B={RNN_B} n={RNN_H}")
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [CKPT_CHILD_FLAG]:
        sys.exit(ckpt_child(sys.argv[2]))
    sys.exit(main())
