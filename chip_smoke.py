#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card and check it.

    python3 chip_smoke.py [--out details.json]

Run from the root of a checkout on a machine with an NVIDIA Hopper card
and the CUDA toolkit.  Phases, each of which fails the run on error:

  1. card       name and power limit from nvidia-smi, device count;
  2. build      every kernel source of the port, one nvcc each, started
                together; nvcc's -Xptxas -v lines (registers, shared
                memory, spills) printed (for nm_compact's many
                instantiations a summary and the element pack's kernels)
                and kept in the details; static SASS counts (cuobjdump)
                of the element pack's nm_compact kernels;
  3. kernels    nm_spmm against its plain PyTorch version at the
                shapes of qwen3-8b (the seven projections, B in
                {4, 32, 128, 1024, 2048}, u4 and u8 indices) and at ragged
                shapes, within |kernel - plain| <= 1e-5 * (|act| @ |W|):
                both sum the same exact bf16 products in fp32, in other
                orders; rows must also be bitwise independent of the
                batch (row 0 equals the B = 1 result) and of the run;
  4. timing     device times (CUDA graph replay between CUDA events)
                with the weights cold in L2: kernel,
                its bound (bytes over 3.35 TB/s or operations over 989
                TFLOP/s bf16, whichever is larger), the plain version,
                and torch.matmul on the dense bf16 weight as a yardstick;
  5. small      the port at qwen3-8b SMOKE size on the card against the
                same port on the CPU (the plain path the CPU tests hold
                against the JAX reference): logits within 2e-2;
  6. serve      qwen3-8b FULL widths (d_model 4096, vocab 151936) at 9
                of its 36 layers (SERVE_LAYERS),
                bf16 weights from a seed, drawn and 2:8 u4-packed layer by
                layer, served by ServeEngine(n_slots=4, prompt_bucket=32,
                max_len=96, packed=True) on six requests that join
                mid-flight; every batched stream must equal its solo
                stream and the nm_spmm launch count must be
                7 x 9 x (prefills + decode steps), the pack's nm_compact
                launches 7 x 9, every one on the vector variant (pack
                time without the draws); then five
                decode steps under torch.profiler give the device's busy time
                and idle share per step and the top kernels and host ops;
  7. update     the fused_update kernel against its plain version at the
                qwen3-8b projection shapes as the optimizer feeds them
                ((K, F) fp32 master and momentum, bf16 gradient), at
                ragged shapes (fp32 and bf16 gradients) and on heavy ties,
                in its three modes (FF only, srste's cast BP operand,
                bdwp's selected one; bdwp must refuse F % m != 0): w',
                v', vals, idx, the BP operand and the FF mask bitwise
                equal; one layer's 7 sites in one grouped launch against
                per-site plain calls, out of place and in place; then
                device times (CUDA graph replay, cold L2) of each site
                alone and of the layer's grouped launch against the byte
                bound (21.75 B per element at 2:8 with a bf16 gradient
                over 3.35 TB/s) and the plain version;
  8. train rows nm_spmm at B = 2048 rows (4 x 512 tokens) and at the
                1024 rows of one pod of phase 14, u8 indices, the seven
                shapes: within the phase-3 tolerance of the plain
                version; device times beside torch.matmul on the dense
                weight, against
                the N:M bound (max(bytes / 3.35 TB/s, 2*B*Kc*F / 989
                TFLOP/s)) and the dense work (2*B*K*F / 989 TFLOP/s), the
                per-layer factors and the split-K scratch bytes; the
                plain version's time at B = 2048;
  9. small train qwen3-8b SMOKE, 2:8 bdwp, packed pre-generation: three
                steps on the card and on the CPU from the same params
                and batches; the step-0 compute trees bitwise equal,
                losses within SMALL_LOSS_ATOL, mask match rates printed;
 10. train      qwen3-8b TRAIN (every FULL width, 8 of 36 layers), 2:8
                bdwp, packed pre-generation, 4 x 512 tokens a step: five
                timed steps with finite losses and exactly 2 x 7 x 8
                nm_spmm launches (forward and the blocks' recompute) and
                one grouped fused_update launch over the 7 x 8 sites per
                step; after a sixth step under torch.profiler (forward /
                backward / update, device busy and idle, top kernels; no
                argmax reduce left), layer 0's packed operands equal
                nm_pack of its new fp32 master, its stored mask nm_mask of
                it and its BP operand the BP-axis mask's;
 11. sync kernels grad_compress and grad_decompress_mean, each in its
                vector and its scalar variant, against their plain
                versions: buckets (2, 65536) and (P, 4096) for P in 1..4,
                ragged K (K = m, 513 groups, a partial tile), 2:4, 1:8,
                3:8, 4:16, heavy ties, bf16 and fp32 gradients, strided
                rows, rows off a whole m-group (the scalar variant only,
                which "auto" must pick), the residual written in place:
                vals, idx, err' and the mean (fp32 and the gradient's
                dtype) bitwise equal, and decode(vals, idx) + err' == g +
                err bitwise; the w_gate (2, 50331648) and embed
                (2, 622854144) leaves the same way;
                device times (CUDA graph replay) of both variants at
                those two leaves (cold by their size) and at the
                reference's bucket (2, 65536) (cold copies), the mean in
                the gradient's dtype as the sync writes it, against the
                byte bound over 3.35 TB/s and the plain versions;
 12. sync alone cross_pod_sync at qwen3-8b TRAIN_SYNC leaf shapes, 2 pods
                of random bf16 gradients and a random residual: one
                launch of each kernel per leaf (47, all vector variant),
                against the reference's 1 << 16 buckets launched chunk by
                chunk from plan_sync (30,801 of each): mean gradients and
                residuals bitwise equal, ms per sync for both;
 13. small sync qwen3-8b SMOKE compressed training, 2 pods: three steps
                on the card and on the CPU; the card's sync of each step
                equals the CPU sync of the same pod-stacked gradients
                bitwise, losses within SMALL_LOSS_ATOL;
 14. train sync qwen3-8b TRAIN_SYNC (every FULL width, 4 of 36 layers),
                2 pods x (2 x 512) tokens a step, compressed sync: five
                timed steps with finite losses and exactly 2 x 7 x 4 x 2
                nm_spmm, one fused_update over 7 x 4 sites, and 47
                grad_compress and 47
                grad_decompress_mean launches per step (one per leaf),
                every one on the vector variant; on one step the EF
                identity on layer 0's w_gate; a sixth step under
                torch.profiler (forward / backward / sync / update),
                peak memory;
 15. compact / shared  nm_compact against its plain version, bitwise, in
                both variants: the seven weights as the element pack
                reads them (strided (K, F) bf16, groups along K, u4 and
                u8) and strided cases (1:8 u4 with an odd group count,
                3:8, 2:4, 4:16 fp32, -0 ties, NaNs of any payload, two in
                many groups), where "vector" must run; F = 1000 and a
                view off by one element, where "auto" must take the
                scalar variant and "vector" must refuse; fp32 score rows
                (1, K) and (nf, K), odd Kc with u4, K = m, 2:4, 1:8, 3:8,
                4:16, heavy ties with -0 (contiguous rows: the scalar
                variant); device times per layer (CUDA graph replay,
                cold L2, the median of three in turns) of the vector and
                the scalar variant (u4) and of the vector one (u8),
                against their byte bounds and the plain version;
                nm_spmm_shared against
                its plain version within the phase-3 tolerance, rows
                bitwise independent of the batch: the seven shapes at
                B = 4 and at prefill rows (4 x 32) as one tile (TF = F),
                pack_shared's TF = 128, ragged B / Kc / TF and dtypes;
                device times (CUDA graph replay, cold L2) per layer
                against the byte bound, the plain version and
                torch.matmul on the dense bf16 weight;
 16. small shared qwen3-8b SMOKE, 2:8 shared granularity: pack_tree_shared
                on the card and on the CPU bitwise equal; prefill + 8
                greedy decode steps, logits within SMALL_ATOL;
 17. shared serve  qwen3-8b FULL widths at 9 layers, bf16 weights
                from a seed packed layer by layer by pack_tree_shared on
                the card (exactly 7 x 9 nm_compact launches, on the
                scalar variant: the score rows are contiguous; layer 0
                bitwise the plain pack); 4 prompts of 5-32 tokens
                right-padded to 32 and prefilled with last_index, then
                16 greedy lm_decode_steps with exactly 7 x 9 x 17
                nm_spmm_shared launches; each prompt's tokens unchanged
                when the batch's rows are permuted; prefill ms, decode
                ms/step and tok/s, five decode steps under
                torch.profiler;
 18. paper kernels  nm_spmm at the ViT's rows (512 images x 65 tokens =
                33,280) and its six linear shapes, u8: within the
                phase-3 tolerance, row 0 bitwise the B = 1 result; device
                times beside dense torch.matmul, the bound and the plain
                version; fused_update over each model's site list (the
                (H*W*I, O) views of every ResNet9 and VGG19 conv site,
                ViT's linears) in one grouped launch, bitwise against
                per-site plain calls, out of place and in place; timed
                (cold L2 by cycled copies) per view alone and as the
                step's one grouped launch;
 19. small paper ResNet9 (width 16) and a 2-block ViT, 2:8 bdwp, packed:
                three steps on the card and on the CPU from the same
                params and batches; step-0 compute trees bitwise equal,
                losses within PAPER_SMALL_LOSS_ATOL; ResNet18 (width 8)
                on the MaskedOp path: logits and gradients, card vs CPU;
                ResNet50's 53 convs one by one on the inputs of its CPU
                forward (at this size the whole model is chaotic) and
                the SAME 3x3/2 max-pool: the stride-2 SAME pads
                on cuDNN;
 20. paper train  ResNet9 (width 64, CIFAR-10 shapes), VGG19 and ViT
                (VIT_PAPER; both CIFAR-100 shapes) at Table I's batch of
                512, 2:8 bdwp, packed pre-generation, the paper's lr and
                weight decay: five timed steps each (batches drawn
                before the clock) with finite losses and exactly one
                fused_update launch over 7 / 15 / 42 sites and 0 / 0 / 42
                nm_spmm launches a step;
                a sixth under torch.profiler; ms/step, images/s, peak
                memory; the first site's stored operands equal the pack
                of its new fp32 master;
 21. dataflow small qwen3-8b SMOKE, three steps on the card and on the
                CPU for each of dense, srste, sdgp, sdwp and bdwp on the
                pre-generating and the legacy (pregen=False) dataflow,
                bdwp with shared masks, with transposable masks (packed
                and not) and the legacy compressed step (2 pods): step-0
                compute trees bitwise, losses within SMALL_LOSS_ATOL,
                one fused_update launch a step for element srste/bdwp
                pre-generation and none for the others; then on the
                legacy dataflow under each of the five methods phase
                19's small ResNet9, three steps each from a copy of the
                CPU run's state (loss within PAPER_SMALL_LOSS_ATOL, the
                update given the CPU's gradients bitwise), and phase
                19's ResNet18 logits, gradients and its 20 convs one by
                one, card vs CPU; SDGP's backward selects on the
                gradient itself, so its gradients are held conv by conv,
                each fed the CPU's input, weight and incoming gradient
                (the selection bitwise, dx/dw within 2^-7), after the
                card's own incoming gradient at s2b1/c1 selected on the
                CPU gives the card's selection bitwise (the groups where
                the two runs' selections differ, their near-ties in
                ulps, and where in the backward they first differ, are
                printed);
 22. train transposable  qwen3-8b TRAIN at 2 of its 8 layers (every
                width), 2:8 bdwp with transposable
                masks, packed: five timed steps with exactly 2 x 7 x 2
                nm_spmm launches and no fused_update launch a step (the
                reference keeps transposable sites off the fused kernel),
                a profiled sixth; layer 0's operands against
                nm_mask_transposable of a CPU copy of its new master
                (a leading 512 x 2048 block of each projection); the
                mask selection's time over the 14 sites;
 23. train shared  the same with shared-granularity masks (tile 128),
                pre-generated and unpacked: no nm_spmm or fused_update
                launch; then pack_tree_shared on the trained master and
                the share of each FF operand's surviving |w| mass its one
                row pattern keeps;
 24. train legacy  the same on the legacy dataflow (pregen=False): no
                compute tree in the state, no nm_spmm or fused_update
                launch;
 25. paper legacy  ResNet9 under each of Fig. 4's five methods, ResNet18
                and ResNet50 under 2:8 bdwp, legacy dataflow, at Table
                I's widths and batch (a batch that does not fit is
                halved and said so): five timed steps each, no nm_spmm or
                fused_update launch; ms/step, images/s, peak memory;
 26. fig4       Fig. 4 on the card: ResNet9 (width 32, batch 64, lr
                0.05, 10 warmup steps, 120 steps, 2:8, legacy dataflow)
                under the five methods and the reference's seeds
                (examples/torch_paper_loss_curves.py) against the
                committed reference curves
                (results/fig4_reference_curves.json): at least half of
                each method's runs learn (settled loss below ln 10 -
                0.1), each method's tail-20 mean inside its band, the
                ordering as the reference reads where the reference
                resolves it; the same check must reject runs at lr 0 (2
                seeds a method) and flat chance-level and frozen curves;
                Table I's lr (0.5, 100 warmup) at seed 0 beside the
                reference's curves;
 27. arch kernels  qwen2.5-32b, glm4-9b, gemma3-12b and internvl2-26b at
                their seven projection shapes: nm_spmm at B = 4 (u4)
                and at the TRAIN step's rows (u8) within the phase-3
                tolerance, deterministic, row 0 bitwise the B = 1
                result, timed beside dense torch.matmul; one layer's 7
                sites in one grouped fused_update launch bitwise the
                per-site plain version, in place and out of place;
                nm_compact of the seven weights (u4, both variants)
                bitwise;
 28. arch small each of them at SMOKE size, card vs CPU: forward logits,
                three BDWP packed pre-generating steps (step-0 compute
                trees bitwise, losses within SMALL_LOSS_ATOL), prefill
                (internvl2 after a prefix) and 20 decode steps per slot
                and with the shared cursor from u4-packed weights
                (logits within SMALL_ATOL, ARCH_SMALL_ATOL for gemma3
                and internvl2);
 29. arch train each one's TRAIN (every published width, depth cut:
                qwen2.5 4 of 64 layers at 4 x 512 tokens, glm4 8 of 40
                at 4 x 512, gemma3 6 of 48 (one 5:1 period) at 2 x 2048,
                internvl2 4 of 48 at 2 x (1024 prefix + 1024)) through
                phase 10's checks: five timed steps, 2 x 7 x L nm_spmm
                and one fused_update over 7 x L sites a step, a
                profiled sixth, layer 0's operands, peak under 80 GB;
 30. arch serve each one's FULL at every published width and an
                eighth of its depth (qwen2.5 8 of 64 layers, glm4 5 of
                40, gemma3 6 of 48: one 5:1 period, internvl2 6 of 48),
                drawn and 2:8 u4-packed
                layer by layer (7 x L nm_compact, all vector): qwen2.5,
                glm4 and gemma3 through phase 6's engine run (gemma3
                with prompts of 1100-1200 tokens in a bucket of 1280, so
                the band in prefill and the window in decode bite), then
                gemma3's shared-cursor decode: each layer's attention on
                the prefill's cache against per-slot decode within a
                few bf16 ulps, two planted faults (window ignored, off
                by one) caught; 4 rows, 16 steps, 7 x L nm_spmm a step,
                logits against per-slot decode on the same
                tokens; internvl2 through lm_prefill_step with a
                1024-row prefix and 16 decode steps; ms, tok/s, idle
                share, peak;
 31. moe kernels granite-moe-1b-a400m's expert stacks (E = 32) in one
                stacked nm_spmm launch, u8: at the TRAIN step's 1280 rows
                an expert (w_gate/w_up 1024 -> 512, w_down 512 -> 1024)
                and at B = 8: within the phase-3 tolerance of the plain
                version, every expert bitwise a 2-D launch on that expert,
                row 0 bitwise the B = 1 result; timed (CUDA graph replay,
                cold L2) beside 32 separate 2-D launches, torch.bmm on the
                dense bf16 stacks and the plain version, against the
                bound; one layer's 7 sites (4 attention, 3 (E*K, F)
                expert views) in one grouped fused_update launch, bitwise
                the plain version, timed against 21.75 B/element; the
                four attention projections as phase 27 holds the dense
                archs': nm_spmm at B = 4 (u4) and the TRAIN step's 4096
                rows (u8), nm_compact of the four weights (vector and
                scalar) bitwise;
 32. moe small  granite SMOKE, card vs CPU: forward logits (within
                MOE_SMALL_ATOL) and aux; the routing tables of the same
                probabilities bitwise; three BDWP packed pre-generating
                steps (loss, aux, total within MOE_PACKED_STEP_ATOL;
                step-0 compute trees bitwise) and three legacy steps
                (within SMALL_LOSS_ATOL); prefill and 20 decode steps, u4
                attention, masked experts (within MOE_SMALL_ATOL);
 33. moe train  granite TRAIN (every published width, 6 of 24 layers,
                MOE_LAYERS; 4 x 1024 tokens: 8 routing groups of 512,
                capacity 160) through phase 10's checks: five timed
                steps, exactly 84 nm_spmm (2 x (4 + 3) x 6, one launch
                per expert stack) and one fused_update over 42 sites a
                step, a profiled
                sixth with the moe/route, moe/dispatch, moe/experts and
                moe/combine ranges, layer 0's operands (expert stacks
                per expert), peak;
 34. moe serve  granite FULL widths at 12 layers through phase 6's
                engine run: attention 2:8 u4-packed (4 x 12 nm_compact a
                pack, 4 x 12 nm_spmm an engine step), the expert stacks
                bf16 and
                re-masked on every call as the reference serves them;
                batched streams equal solo streams; the experts' mask
                derivation's device ms a decode step;
 35. deepseek kernels  deepseek-v2-lite-16b's shapes: nm_spmm on the
                64-expert stacks in one launch at the TRAIN step's 480
                rows an expert (w_gate/w_up 2048 -> 1408, w_down 1408 ->
                2048, u8) as phase 31 holds granite's (64 separate 2-D
                launches); one MoE layer's 11 sites (5 MLA projections,
                3 (E*K, F) expert views, 3 shared-expert matrices) in one
                grouped fused_update launch, bitwise, timed against
                21.75 B/element; the 2-D shapes (q_proj 2048 -> 3072,
                kv_down 2048 -> 576, k_up/v_up 512 -> 2048, o_proj, the
                prelude's 2048 -> 10944 and 10944 -> 2048, the shared
                experts' 2048 -> 2816 and 2816 -> 2048) as phase 27
                holds the dense archs', nm_compact of each bitwise;
 36. deepseek small  deepseek SMOKE (MLA, the prelude, 2 shared experts)
                card vs CPU as phase 32 (the packed steps within
                DS_PACKED_STEP_ATOL, a limit a step), plus 20
                shared-cursor decode steps of the absorbed MLA decode;
 37. deepseek train  deepseek TRAIN (every published width, the prelude
                and 5 of 26 MoE layers, 4 x 1024 tokens: 480 rows an
                expert) through phase 10's checks: five timed steps,
                exactly 118 nm_spmm (8 prelude sites once, 11 sites of
                each MoE layer twice) and one fused_update over 63
                sites (3.00 G elements, past 2^31) a step, a profiled
                sixth with the moe/* ranges, the operands of layer 0,
                the prelude and the last layer, peak;
 38. deepseek serve  deepseek FULL's widths at the prelude and 4 of
                its 26 MoE layers (5 of 27)
                through phase 6's engine run with 4 prompts: MLA's
                q_proj, kv_down and o_proj and the prelude packed 2:8 u4
                (15 nm_compact a pack, 15 nm_spmm a forward), k_up/v_up
                read raw by the absorbed decode, the experts and shared
                experts bf16 and re-masked on every call; batched streams
                equal solo streams (cap = t at 4 slots); the experts'
                mask derivation's device ms a decode step;
 39. ssm kernels  mamba2-370m's and hymba-1.5b's sites (mamba2: in_proj
                1024 -> 4384, out_proj 2048 -> 1024; hymba: its
                attention and FFN projections and out_proj 3200 -> 1600;
                its in_proj 1600 -> 6482 is no site) as phase 27 holds
                the dense archs': nm_spmm at B = 4 (u4) and the TRAIN
                step's 8192 rows (u8), the plain version timed at
                both; one layer's sites in one grouped fused_update
                launch, bitwise, timed against 21.75 B/element;
                nm_compact of each weight bitwise and each FULL element
                pack (96 / 256 weights) timed shape by shape;
 40. ssm small  both SMOKE configs, card vs CPU: forward logits, prefill
                with a cache (logits within 1e-4 of the forward's last
                position on each side; the fp32 SSM state and conv window
                within SSM_STATE_ATOL), prefill and 20 decode steps per
                slot and with the shared cursor from u4-packed weights
                (hymba's window of 16 crossed), the reference hazard of the
                right-padded prefill (same logits, another state and
                first decode step) on both sides, three packed
                pre-generated steps (step-0 compute trees bitwise) and
                one legacy step (losses within SMALL_LOSS_ATOL);
 41. ssm train  each one's TRAIN (every published width, 6 of 48 / 4 of
                32 layers, SSM_LAYERS; 4 x 2048 tokens: hymba's
                attention banded past its 1024 window, 16 SSD chunks)
                through phase 10's checks: five timed steps, exactly
                24 / 64 nm_spmm and one fused_update over 12 / 32 sites
                a step, a profiled sixth with the ssm/conv, ssm/scan and
                ssm/out ranges, layer 0's operands equal to the pack of
                the new master, peak;
 42. ssm serve  each one's FULL widths at the same depth through phase
                6's engine run, 2:8 u4-packed (12 / 32 nm_compact a
                pack, all vector; 12 / 32 nm_spmm a forward; hymba's
                in_proj dense): batched streams equal solo streams; ms,
                tok/s, decode idle share;
 43. whisper kernels  whisper-large-v3's shapes: nm_spmm (1280 -> 1280,
                1280 -> 5120, 5120 -> 1280) at B = 4 (u4) and at the
                TRAIN step's 12,000 encoder rows (u8), and 1280 -> 1280
                at a decode step's 6,000 cross-K/V rows (u4), within the
                phase-3 tolerance, row 0 the B = 1 result, timed beside
                torch.matmul and the plain version; nm_compact of each
                shape bitwise; one decoder layer's 10 sites in one
                grouped fused_update launch, bitwise, timed against
                21.75 B/element; one launch over 512 small sites (its
                table in device memory) bitwise; the FULL element pack's
                512 weights timed shape by shape;
 44. whisper small  whisper SMOKE, card vs CPU: the encoder output and
                logits, the prefill with a cache (within 1e-4 of the
                forward's last position on each side), a seated cache's
                20 shared-cursor decode steps from u4-packed weights,
                the reference hazard (an unseated prefill cache decodes
                over the last prompt position) on both sides, three
                packed pre-generated steps (step-0 compute trees
                bitwise) and one legacy step;
 45. whisper train  whisper TRAIN (every width, 4 + 24 of its 32 + 32
                layers), 8 rows of 1500 frames and 448 tokens: five
                timed steps, exactly 2 x (6 x 4 + 10 x 24) nm_spmm and
                one fused_update over 264 sites (past the 256 of its
                by-value table) a step, a profiled sixth with the
                encdec/encoder, encdec/decoder and encdec/cross_kv
                ranges, the first and last layers' operands of both
                stacks equal to the pack of the new master, peak;
 46. whisper serve  whisper FULL widths at 4 + 4 layers, 2:8 u4-packed
                (all nm_compact vector): 4 rows of their own 1500 frames
                and Whisper's 4-token start prompt prefilled, the cache
                seated in a 448-long one, 32 greedy decode steps on the
                shared cursor (the cross K/V at 6,000 rows every step);
                each row's tokens equal its solo run's among idle slots;
                row 0 decoded alone (B = 1) equals row 0 of the 4-row
                batch bitwise, logits of the prefill and 16 decode steps
                (the decoder runs under layers.batch_invariant: the
                attention and the LayerNorms at a batch padded to 8
                rows), and the same without it, with the decode ms a
                step both ways; prefill ms, decode ms a step, tok/s,
                the decode idle share and the cross K/V's share;
 47. new sync leaves  grad_compress and grad_decompress_mean at the
                units the sync launches for granite's (32, 1024, 512)
                and deepseek's (64, 2048, 1408) expert stacks, deepseek's
                prelude FFN, mamba2's in_proj, conv_w and A_log, hymba's
                conv_w, in_proj and its 32-layer A_log stack (2 pods):
                both variants bitwise against the plain versions with
                the EF identity, device times against the byte bound and
                the plain version; hymba FULL's SSD leaves of 32 layers
                through cross_pod_sync, card == CPU bitwise;
 48. mvue       given the same uniforms, the mvue cross_pod_sync of a
                tree with an expert stack, a ragged leaf and a 32-layer
                stack on the card equals the CPU's bitwise and keeps the
                residual; step-seeded draws repeat and differ by step;
                over 4096 draws of one gradient the mean estimate lies
                within 5 standard errors (entries drawn 25 times or
                more); mvue_compress timed beside grad_compress;
 49. granite sync granite-moe-1b-a400m TRAIN (every width, 6 of 24
                layers), 2 pods on one card, topk compressed sync, 2:8
                bdwp packed, 4 x 1024 tokens, the launcher's settings,
                under torch.use_deterministic_algorithms (the MoE
                backward's index_select gradient is an atomic
                scatter-add otherwise, and two runs part in the last
                bits):
                five timed steps with exactly 2 x 7 x 6 x 2 nm_spmm,
                one fused_update over 42 sites and one grad_compress and
                one grad_decompress_mean per unit (62) a step; the
                state's fingerprints after step 3, a profiled sixth step
                (the sync's share), peak;
 50. processes  the same run in two processes on the one card through
                the launcher (torchrun --standalone, the mesh "pod=2",
                gloo; NCCL refuses two ranks on one card;
                --deterministic), 3 steps: losses and each rank's state
                (shared state and residual row) bitwise phase 49's after
                3 steps (fingerprints), each rank's launches, the
                backend, the gathers and bytes a step against
                wire_bytes;
 51. FSDP       one qwen3-8b TRAIN layer's update at data=2: each rank's
                grouped fused_update over its 7 block sites (rows K/2,
                columns F/2 of o_proj and w_down) bitwise the slice of
                the whole layer's update, timed against its byte bound;
                how far the embedding lookup's backward (repeated tokens
                summed in bf16) lies from an fp32 sum (reported);
                then qwen3-8b at every width, 2 of 36 layers, through
                the launcher's --mesh data=2 (two processes on the one
                card, gloo), 3 steps of 4 x 512 tokens: losses within
                2e-3 and the master within 1e-3 of the one-process step
                on the same rows (the reference's own sharded-vs-single
                tolerance, at its optimizer; the master read from the
                launcher's checkpoint) and each master leaf's change
                within 2e-2 of the one-process change, a second run
                bitwise the first, and per rank its state bytes, peak,
                ms/step, bytes gathered and reduced a step, launches;
 52. pod x data granite-moe-1b-a400m at every width, 6 of 24 layers:
                each rank's compressed sync of its blocks bitwise its
                slice of the one-card sync of the whole gradients (mean
                and residual, one grad_compress and grad_decompress_mean
                a unit of its plan); then the launcher's --mesh
                pod=2,data=2 --compress (four processes on the card), 3
                steps of 4 x 1024 tokens: losses within 2e-3, the
                master within 3e-3 and each leaf's change within 0.25
                of phase 49's one-process step (the compressed sync's
                picks flip where the ranks' sums round apart); each
                rank's hop bytes a step equal to wire_bytes of its
                blocks, launches, ms/step, state bytes, peak;
 53. checkpoints granite-moe SMOKE through the launcher: saved at
                data=2, restored at data=1 on the card and saved,
                resumed at data=2 and saved: bitwise; a checkpoint
                without a compute tree resumed at data=2
                (restore_with_pregen) gives the update's compute tree
                bitwise.
 54. fleet      qwen3-8b FULL widths at 9 of 36 layers (SERVE_LAYERS),
                one 2:8 u4 PackedParamStore shared by every engine,
                ServeConfig(n_slots=4, prompt_bucket=32, packed=True):
                4 prompts from the seed, each submitted twice, 16 new
                tokens each, decoded alone on one engine, then through
                a ServeFleet of 1 replica (the control: one engine on
                the same trace), a colocated one of 2 under the prefix,
                least_loaded and random routers, a disaggregated one (1
                prefill engine, 2 decode replicas, which prefill
                nothing) and AsyncFrontend (4 concurrent generate()
                calls): every stream equals its prompt's solo stream,
                and each run's nm_spmm launches equal 7 x 9 x (prefills
                + decode steps); fleet steps, prefills, prefix hits,
                routed_by_depth, ms a fleet step and tok/s a run;
                fleet_meshes(2) raises ValueError on one card.
 55. tp serve   tensor-parallel serving over "model": nm_spmm at one
                rank's block shapes of qwen3-8b at model = 2 (B = 4, u4:
                q, k, v, w_gate, w_up by columns, o_proj and w_down by
                rows) within the phase-3 tolerance, timed against the
                bound, the plain version and torch.matmul on the dense
                block; nm_compact (vector, u4) at those shapes timed;
                then qwen3-8b FULL widths at 9 of 36 layers
                (SERVE_LAYERS), 2:8 u4, ServeConfig(n_slots=4,
                prompt_bucket=32, packed=True): TP_LENS prompts from the
                seed, TP_NEW new tokens each, the last two joining after
                TP_JOIN_AFTER engine steps, on one engine (every prefill's
                and decode step's last-position logits kept), then on
                two processes on the one card at the mesh data=1,model=2
                (gloo: NCCL refuses two ranks on one card), each drawing
                the seed's weights and packing its blocks: each rank's
                store bitwise its blocks of the one-process store
                (fingerprints), its 63 nm_compact launches all vector,
                its nm_spmm launches 7 x 9 x (prefills + decode steps),
                both ranks' streams and logits equal, the teacher-forced
                logits within TP_LOGIT_ATOL (0.2) of the one-process
                logits, every stream equal to its one-process stream or
                parting only where the one-process top-two gap is under
                TP_LOGIT_ATOL (the step and the gap printed), and every
                step's collectives exactly 2 x 9 all-reduces, one
                embedding lookup and one logits gather (plus two KV
                gathers a layer where M does not divide the KV heads);
                per rank the weight bytes against the one-process
                store's, peak, ms a step, tok/s and bytes a prefill and
                a decode step, and the card line.
 56. dp serve   slot lanes over the DP axes and build_lm_serve:
                nm_spmm_shared at both "model" ranks' blocks of one
                qwen3-8b layer at (pod, data, model) = (1, 2, 2) (q, k,
                v, w_gate, w_up by columns with the rows whole; o_proj
                and w_down by rows, the rows rebased by r K / 2) at
                build_lm_serve's rows a rank (B = 2 decode, 64 prefill)
                and at B = 4 and 128, within the phase-3 tolerance of
                the plain version, a column block's output bit for bit
                the whole weight's columns, the two row blocks' outputs
                summed within 2 x that tolerance of the whole weight's
                plain product; rank 0's timed against the bound, the
                plain version and torch.matmul on the dense block;
                then 4 processes on
                the one card (gloo), each drawing the seed's weights:
                the engine (u4, phase 55's requests) at (1, 2, 2) and
                at (2, 2, 1), against phase 55's one engine: each
                rank's store bitwise its blocks (fingerprints), 63
                vector nm_compact and 7 x 9 x (prefills + decode steps)
                nm_spmm a rank, every rank's streams equal, the ranks
                of one DP index' logits equal, teacher-forced logits
                within TP_LOGIT_ATOL and every stream its one-process
                stream or parting only under that top-two gap, every
                step's collectives phase 55's "model" ones (at (1, 2,
                2)) plus one token gather a decode step; then
                build_lm_serve(packed=True) at (1, 2, 2): each rank
                shared-packs the whole weights (63 scalar nm_compact)
                and cuts its blocks (column blocks, and row blocks'
                rows + r K / M, bitwise the whole pack's, against plain
                slices of the one-process pack), prefills its 2 of
                LM_SERVE_ROWS' 4 x 32-token rows and runs
                LM_SERVE_STEPS shared-cursor decode steps fed the
                one-process greedy tokens (phase 17's path at 9
                layers): the gathered logits the same on every rank
                and within TP_LOGIT_ATOL of the one process, tokens
                equal where its top-two gap is over that, 7 x 9 x 17
                nm_spmm_shared a rank, every forward's collectives 18
                all-reduces, one lookup, one logits gather and one DP
                logits gather; weight bytes, peak, ms and the card
                line.

It prints a JSON line with every kernel's numbers, the card line, and as
its last line {"ok": true, "device": {...}}.  With no card, or outside a
checkout, it exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak
TOL = 1e-5                      # kernel vs plain, relative to |act| @ |W|
SMALL_ATOL = 2e-2               # card vs CPU logits at SMOKE size
# card vs CPU SMOKE training losses per step: step 0 differs only by
# bf16 activations that round the other way (as SMALL_ATOL); later steps
# also carry the gradients' bf16 roundings, which differ on the card
# (cuBLAS sums, the lm_head backward in bf16), through lr 0.05 and 0.1
SMALL_LOSS_ATOL = (1e-2, 2e-2, 5e-2)
TRAIN_ROWS = (4, 512)           # sequences x tokens of a training step
UPDATE_SCALARS = dict(lr=0.0123, mu=0.9, wd=5e-4, lam=2e-4)
L2_BYTES = 50 * 2**20
SEED = 0                        # weights, activations and prompts
# phases 6 and 17 serve qwen3-8b at every width and this depth (of 36
# layers), to keep the whole run in its time
SERVE_LAYERS = 9
RANGES = ("train/", "sgd/", "moe/", "ssm/", "encdec/")  # profiler ranges

# qwen3-8b projection shapes (K, F), in the order one layer runs them
PROJ = [("q_proj", 4096, 4096), ("k_proj", 4096, 1024), ("v_proj", 4096, 1024),
        ("o_proj", 4096, 4096), ("w_gate", 4096, 12288),
        ("w_up", 4096, 12288), ("w_down", 12288, 4096)]
# the seven projections of one block, as (sub-dict, name) in the tree
PROJ_PATHS = (("attn", "q_proj"), ("attn", "k_proj"), ("attn", "v_proj"),
              ("attn", "o_proj"), ("ffn", "w_gate"), ("ffn", "w_up"),
              ("ffn", "w_down"))
# phase 3's batch sizes: decode, the engine's prompt bucket, a prefill of
# 4 x 32, and the training rows of phases 14 (one pod) and 10
BATCH_ROWS = (4, 32, 128, 1024, 2048)
# ragged cases: (name, B, K, F, n, m, idx_bits)
RAGGED = [("B=1", 1, 4096, 4096, 2, 8, 4), ("B=3", 3, 4096, 1024, 2, 8, 8),
          ("F=1000", 4, 512, 1000, 2, 8, 4), ("odd Kc u4", 5, 56, 20, 1, 8, 4),
          ("B=37", 37, 1024, 384, 2, 8, 4), ("2:4", 4, 256, 256, 2, 4, 4),
          ("4:16 F=130", 2, 512, 130, 4, 16, 4),
          ("3:8 B=300", 300, 768, 200, 3, 8, 8),
          ("1:4 K=36", 3, 36, 40, 1, 4, 8),
          ("2:6 B=600", 600, 480, 64, 2, 6, 8),
          ("odd Kc u4 B=2048", 2048, 56, 20, 1, 8, 4)]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# kernels whose -Xptxas -v lines and static SASS counts phase 2 prints
# from a library with many instantiations: the element pack's nm_compact
# (bf16, m = 8; vector 2:8 u4 and u8, scalar u4)
SASS_KERNELS = {
    "nm_compact": {
        "vector 2:8 u4": "nm_compact_vec_kernelI13__nv_bfloat16Li8ELi2ELi4E",
        "vector 2:8 u8": "nm_compact_vec_kernelI13__nv_bfloat16Li8ELi2ELi8E",
        "scalar m=8 u4": "nm_compact_kernelI13__nv_bfloat16Li8ELi4E"}}
INT_OPS = {"IMAD", "IADD3", "LOP3", "SHF", "IMNMX", "ISETP", "SEL", "PRMT",
           "LEA", "IABS", "BMSK", "FLO", "POPC", "BREV", "VIMNMX", "IMUL"}


def ptxas_entries(log: str) -> dict:
    """nvcc -Xptxas -v's log split by kernel: {mangled name: its lines}."""
    entries, name = {}, None
    for line in log.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w]+)'?", line)
        if found:
            name = found.group(1)
        if name:
            entries.setdefault(name, []).append(line.strip())
    return entries


def print_build_log(name: str, log: str) -> None:
    """nvcc's log as it is, or for a library of many kernels one summary
    line plus the kernels of SASS_KERNELS."""
    if log.count("\n") <= 60:
        print("    " + log.strip().replace("\n", "\n    "))
        return
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        log)
    spilled = sum(1 for a, b in spills if int(a) or int(b))
    print(f"    {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
          f"{spilled} with spills (all lines in the details)")
    for label, key in SASS_KERNELS.get(name, {}).items():
        for fn, lines in ptxas_entries(log).items():
            if key in fn:
                print(f"    {label}: " + "; ".join(
                    ln.split(":", 1)[-1].strip() for ln in lines
                    if "Used" in ln or "spill" in ln))


def sass_counts(lib, kernels: dict) -> dict:
    """Static SASS instruction counts (cuobjdump -sass) of the kernels of
    the library ``lib`` named in ``kernels`` ({label: part of the mangled
    name}): all instructions, global loads and stores by opcode, integer
    ALU instructions."""
    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        print(f"  SASS: no {tool}")
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        fn = block.split()[0]
        label = next((k for k, v in kernels.items() if v in fn), None)
        if label is None:
            continue
        ops = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)",
            block))
        counts[label] = {
            "total": sum(ops.values()),
            "loads": {o: c for o, c in ops.items() if o.startswith("LDG")},
            "stores": {o: c for o, c in ops.items() if o.startswith("STG")},
            "integer": sum(c for o, c in ops.items()
                           if o.split(".")[0] in INT_OPS)}
    return counts


def packed_case(gen, b, k, f, n, m, idx_bits, dev):
    from repro_torch.core import sparsity as S

    w = torch.randn((k, f), generator=gen, device=dev).to(torch.bfloat16)
    vals, idx = S.nm_pack(w, n, m, axis=0)
    if idx_bits == 4:
        idx = S.pack_idx_u4(idx, axis=0)
    act = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
    return act, vals, idx


def bound_ms(act, vals, idx, f):
    b = act.shape[0]
    moved = (act.numel() * 2 + vals.numel() * 2 + idx.numel() + b * f * 4)
    ops = 2 * b * vals.shape[0] * f
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, copies: int, iters: int = 20) -> float:
    """Device ms of one fn(i), cycling ``copies`` input sets so the
    weights come from device memory, not L2.

    The ``iters`` calls are captured in a CUDA graph and replayed between
    two CUDA events, so the time is the card's, not the host's launch
    overhead (eager launches of small kernels leave the card idle).
    """
    for i in range(copies):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % copies)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def phase_kernels(dev, gen):
    """Kernel vs plain at the serving shapes and the ragged ones."""
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels import ref

    cases = [(f"{name} B={b} u{bits}", b, k, f, 2, 8, bits)
             for name, k, f in PROJ for b in BATCH_ROWS for bits in (4, 8)]
    cases += [(f"ragged {name}", *rest) for name, *rest in RAGGED]
    worst = 0.0
    for label, b, k, f, n, m, bits in cases:
        act, vals, idx = packed_case(gen, b, k, f, n, m, bits, dev)
        plain = ref.ref_nm_spmm(act, vals, idx, n, m, idx_bits=bits)
        w = ref.decompress_nm(vals, idx, n, m, axis=0, idx_bits=bits)
        scale = act.float().abs() @ w.float().abs()
        del w
        out = K.nm_spmm(act, vals, idx, n, m, idx_bits=bits)
        again = K.nm_spmm(act, vals, idx, n, m, idx_bits=bits)
        row0 = K.nm_spmm(act[:1].contiguous(), vals, idx, n, m,
                         idx_bits=bits)
        torch.cuda.synchronize()
        err = (out - plain).abs()
        excess = float((err - TOL * scale).max())
        abs_err = float(err.max())
        rel_err = float((err / scale.clamp_min(1e-30)).max())
        worst = max(worst, abs_err)
        print(f"  {label:30s} max_abs_err={abs_err:.3e} "
              f"max_rel_err={rel_err:.3e} (tol {TOL:g} x |act|@|W|)")
        check(excess <= 0, f"nm_spmm {label}: error above tolerance")
        check(torch.equal(out, again), f"nm_spmm {label}: not deterministic")
        check(torch.equal(out[:1], row0),
              f"nm_spmm {label}: row 0 depends on the batch")
    return worst


def phase_timing(dev, gen):
    """Per-projection times at B in {4, 32}, u4 (the serving default)."""
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels import ref

    rows = []
    for b in (4, 32):
        for name, k, f in PROJ:
            act, vals, idx = packed_case(gen, b, k, f, 2, 8, 4, dev)
            dense_bytes = k * f * 2
            copies = max(2, -(-2 * L2_BYTES // dense_bytes))
            sets = [(vals, idx)] + [
                packed_case(gen, b, k, f, 2, 8, 4, dev)[1:]
                for _ in range(copies - 1)]
            dense = [ref.decompress_nm(v, i, 2, 8, axis=0, idx_bits=4)
                     for v, i in sets]
            t_k = time_ms(lambda i: K.nm_spmm(act, *sets[i], 2, 8, 4),
                          copies)
            t_p = time_ms(lambda i: ref.ref_nm_spmm(act, *sets[i], 2, 8, 4),
                          copies, iters=10)
            t_l = time_ms(lambda i: torch.matmul(act, dense[i]), copies)
            t_b, by = bound_ms(act, vals, idx, f)
            rows.append({"proj": name, "B": b, "K": k, "F": f, "ms": t_k,
                         "plain_ms": t_p, "library_ms": t_l,
                         "bound_ms": t_b, "bound_by": by})
            print(f"  B={b:2d} {name:7s} {k:5d}x{f:<5d} kernel={t_k:.4f} ms "
                  f"bound={t_b:.4f} ms ({by}) plain={t_p:.4f} ms "
                  f"torch.matmul(dense bf16)={t_l:.4f} ms")
            del sets, dense
    return rows


# fused_update ragged cases: (name, K, F, n, m)
FU_RAGGED = [("K=48 F=1000", 48, 1000, 2, 8), ("K=8 F=1", 8, 1, 2, 8),
             ("2:4 K=64 F=130", 64, 130, 2, 4),
             ("1:8 K=4096 F=77", 4096, 77, 1, 8),
             ("4:16 K=128 F=33", 128, 33, 4, 16)]


def update_case(gen, k, f, dev, ties=False, g_dtype=torch.bfloat16):
    """(w, g, v) as the optimizer feeds the kernel: fp32 master, the WU
    gradient as the step hands it over (bf16), fp32 momentum;
    ``g_dtype`` fp32 gives its fp32 cast; ``ties`` draws small integers
    (many equal |w| and |w'|, negative zeros included)."""
    if ties:
        w, g, v = (torch.randint(-2, 3, (k, f), generator=gen, device=dev)
                   .float() for _ in range(3))
        return torch.where(w == 0, -0.0, w), g.to(g_dtype), v
    w = torch.randn((k, f), generator=gen, device=dev) * k ** -0.5
    g = (torch.randn((k, f), generator=gen, device=dev) * 1e-3).to(
        torch.bfloat16).to(g_dtype)
    v = torch.randn((k, f), generator=gen, device=dev) * 1e-3
    return w, g, v


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape, dtype and bits (+0 != -0, NaN payloads compared)."""
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def update_bound_ms(k, f, n, m, g_bytes=2, bp=True):
    """Bytes of one fused update of a (K, F) site over the memory rate:
    w, g, v read, w', v', vals and idx (n/m each) written, and with
    ``bp`` the bf16 BP operand and the byte FF mask (21.75 B per element
    at 2:8 with a bf16 g)."""
    per = 4 + g_bytes + 4 + 8 + 3 * n / m + (3 if bp else 0)
    return k * f * per / HBM_BYTES_PER_S * 1e3


UPDATE_OUTS = ("w'", "v'", "vals", "idx", "bp", "mask")


def check_update(got, want, label):
    """Every output of a fused update bitwise equal to the plain one;
    returns the largest |difference| (0 when equal)."""
    check(len(got) == len(want), f"fused_update {label}: {len(got)} "
          f"outputs, the plain version {len(want)}")
    worst = 0.0
    for name, a, b in zip(UPDATE_OUTS, got, want):
        check(bits_equal(a, b),
              f"fused_update {label}: {name} not bitwise equal")
        worst = max(worst, float((a.float() - b.float()).abs().max()))
    return worst


def grouped_update_check(gen, views, dev, s, label, n=2, m=8):
    """One grouped launch over the (K, F) ``views`` (bf16 gradients,
    bdwp) against per-site plain calls, out of place and in place."""
    from repro_torch.kernels import fused_update as K
    from repro_torch.kernels import ref

    sites = [update_case(gen, k, f, dev) for k, f in views]
    args = (s["lr"], s["mu"], s["wd"], s["lam"], n, m, "bdwp")
    before = (K.launches, K.launched_sites)
    got = K.fused_update_sites(sites, *args)
    check((K.launches - before[0], K.launched_sites - before[1])
          == (1, len(sites)), f"fused_update {label}: not one grouped "
          "launch over every site")
    copies = [(w.clone(), g, v.clone()) for w, g, v in sites]
    inplace = K.fused_update_sites(copies, *args, inplace=True)
    worst = 0.0
    for (w, g, v), a, b in zip(sites, got, inplace):
        want = ref.ref_fused_update(w, g, v, n=n, m=m, axis=0,
                                    bp_mode="bdwp", **s)
        torch.cuda.synchronize()
        worst = max(worst, check_update(a, want, f"{label} grouped"),
                    check_update(b, want, f"{label} grouped in place"))
        del want
    return worst


def phase_update(dev, gen):
    """fused_update vs plain (bitwise), single site and grouped, then
    times of single sites and of one layer's grouped launch."""
    from repro_torch.kernels import fused_update as K
    from repro_torch.kernels import ref

    dyadic = dict(lr=0.25, mu=0.5, wd=0.25, lam=0.5)
    cases = [(name, k, f, 2, 8, False, torch.bfloat16) for name, k, f in PROJ]
    cases += [(f"ragged {name}", k, f, n, m, False,
               torch.float32 if i % 2 else torch.bfloat16)
              for i, (name, k, f, n, m) in enumerate(FU_RAGGED)]
    cases += [("ties 2:8 K=512 F=300", 512, 300, 2, 8, True, torch.bfloat16),
              ("ties 2:8 K=512 F=304", 512, 304, 2, 8, True, torch.bfloat16),
              ("ties 4:16 K=64 F=96", 64, 96, 4, 16, True, torch.bfloat16),
              ("ties 1:4 K=64 F=64", 64, 64, 1, 4, True, torch.float32)]
    worst = 0.0
    for label, k, f, n, m, ties, g_dtype in cases:
        w, g, v = update_case(gen, k, f, dev, ties, g_dtype)
        s = dyadic if ties else UPDATE_SCALARS
        modes = (None, "srste") + (("bdwp",) if f % m == 0 else ())
        for mode in modes:
            got = K.fused_update(w, g, v, s["lr"], s["mu"], s["wd"],
                                 s["lam"], n, m, bp_mode=mode)
            want = ref.ref_fused_update(w, g, v, n=n, m=m, axis=0,
                                        bp_mode=mode, **s)
            torch.cuda.synchronize()
            worst = max(worst, check_update(got, want, f"{label} {mode}"))
            del got, want
        if f % m:
            try:
                K.fused_update(w, g, v, s["lr"], s["mu"], s["wd"], s["lam"],
                               n, m, bp_mode="bdwp")
                check(False, f"fused_update {label}: bdwp with F % m != 0 "
                      "was not refused")
            except ValueError:
                pass
        print(f"  {label:24s} g {str(g_dtype)[6:]:8s} modes "
              f"{', '.join(map(str, modes))}: every output bitwise equal"
              + ("; bdwp refused (F % m)" if f % m else ""))
    views = [(k, f) for _, k, f in PROJ]
    worst = max(worst, grouped_update_check(gen, views, dev, UPDATE_SCALARS,
                                            "one layer's sites"))
    print(f"  one layer's {len(views)} sites in one grouped launch (bf16 g, "
          "bdwp): bitwise equal to per-site plain calls, out of place and "
          "in place")
    rows, s = [], UPDATE_SCALARS
    args = (s["lr"], s["mu"], s["wd"], s["lam"], 2, 8)
    for name, k, f in PROJ:
        sets = [update_case(gen, k, f, dev) for _ in range(2)]
        t_k = time_ms(lambda i: K.fused_update(*sets[i], *args,
                                               bp_mode="bdwp"), 2)
        t_p = time_ms(lambda i: ref.ref_fused_update(
            *sets[i], n=2, m=8, axis=0, bp_mode="bdwp", **s), 2, iters=3)
        t_b = update_bound_ms(k, f, 2, 8)
        rows.append({"proj": name, "K": k, "F": f, "ms": t_k,
                     "plain_ms": t_p, "bound_ms": t_b, "bound_by": "bytes",
                     "library_ms": None})
        print(f"  {name:7s} {k:5d}x{f:<5d} one site kernel={t_k:.4f} ms "
              f"bound={t_b:.4f} ms (bytes, 21.75 B/element) "
              f"plain={t_p:.4f} ms bound/kernel={t_b / t_k:.2f}")
        del sets
    layer = [update_case(gen, k, f, dev) for _, k, f in PROJ]
    t_g = time_ms(lambda i: K.fused_update_sites(layer, *args, "bdwp"), 1,
                  iters=10)
    t_b = sum(r["bound_ms"] for r in rows)
    grouped = {"sites": len(layer), "ms": t_g, "bound_ms": t_b,
               "bound_by": "bytes", "singles_ms": sum(r["ms"] for r in rows),
               "plain_ms": sum(r["plain_ms"] for r in rows),
               "library_ms": None}
    print(f"  one layer's {len(rows)} sites, one grouped launch: {t_g:.4f} "
          f"ms against a {t_b:.4f} ms bound (bound/kernel "
          f"{t_b / t_g:.2f}); {len(rows)} single launches "
          f"{grouped['singles_ms']:.4f} ms; plain "
          f"{grouped['plain_ms']:.3f} ms")
    del layer
    return worst, rows, grouped


def spmm_train_bound_ms(b, k, f, kc):
    """The N:M product's bound: its bytes over 3.35 TB/s or its 2*B*Kc*F
    operations over 989 TFLOP/s, whichever is larger."""
    moved = b * k * 2 + kc * f * 3 + b * f * 4
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, 2 * b * kc * f / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def dense_work_ms(b, k, f):
    """2*B*K*F operations over 989 TFLOP/s: the dense-tile design's
    work (the dense product's), which a 2:4 path would halve."""
    return 2 * b * k * f / BF16_OPS_PER_S * 1e3


def spmm_case_err(gen, b, name, k, f, dev):
    """nm_spmm at B rows, 2:8 u8, against the plain version within the
    phase-3 tolerance: (act, vals, idx, dense W, max abs error)."""
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels import ref

    act, vals, idx = packed_case(gen, b, k, f, 2, 8, 8, dev)
    out = K.nm_spmm(act, vals, idx, 2, 8, idx_bits=8)
    plain = ref.ref_nm_spmm(act, vals, idx, 2, 8, idx_bits=8)
    w = ref.decompress_nm(vals, idx, 2, 8, axis=0, idx_bits=8)
    scale = act.float().abs() @ w.float().abs()
    torch.cuda.synchronize()
    err = (out - plain).abs()
    check(float((err - TOL * scale).max()) <= 0,
          f"nm_spmm B={b} {name}: error above tolerance")
    return act, vals, idx, w, float(err.max())


def phase_spmm_train(dev, gen):
    """nm_spmm at training rows, B = 2048 (phase 10) and B = 1024 (one
    pod of phase 14): error, then device times beside torch.matmul on
    the dense bf16 weight, against the N:M bound and the dense work,
    with the split-K scratch; the plain version's time at B = 2048."""
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels import ref

    b_train = TRAIN_ROWS[0] * TRAIN_ROWS[1]
    b_pod = SYNC_ROWS[0] // SYNC_PODS * SYNC_ROWS[1]
    worst = 0.0
    rows, pod_rows = [], []
    for b in (b_train, b_pod):
        for name, k, f in PROJ:
            act, vals, idx, w, e = spmm_case_err(gen, b, name, k, f, dev)
            worst = max(worst, e)
            pl = K.plan(b, k, f, 2, 8)
            t_k = time_ms(lambda i: K.nm_spmm(act, vals, idx, 2, 8, 8), 1,
                          iters=10)
            t_l = time_ms(lambda i: torch.matmul(act, w), 1, iters=10)
            t_p = (time_ms(lambda i: ref.ref_nm_spmm(act, vals, idx, 2, 8,
                                                     8), 1, iters=3)
                   if b == b_train else None)
            t_b, by = spmm_train_bound_ms(b, k, f, vals.shape[0])
            r = {"proj": name, "B": b, "K": k, "F": f, "ms": t_k,
                 "plain_ms": t_p, "library_ms": t_l, "bound_ms": t_b,
                 "bound_by": by, "dense_work_ms": dense_work_ms(b, k, f),
                 "config": pl.config, "splits": pl.splits,
                 "scratch_bytes": pl.scratch_floats * 4, "max_abs_err": e}
            (rows if b == b_train else pod_rows).append(r)
            print(f"  B={b} {name:7s} {k:5d}x{f:<5d} kernel={t_k:.4f} ms "
                  f"torch.matmul(dense bf16)={t_l:.4f} ms bound={t_b:.4f} "
                  f"ms ({by}; dense work {r['dense_work_ms']:.4f})"
                  + (f" plain={t_p:.3f} ms" if t_p is not None else "")
                  + f"; config {pl.config}, split-K {pl.splits}, scratch "
                  f"{r['scratch_bytes'] / 2**20:.1f} MiB")
            del act, vals, idx, w
    for b, rs in ((b_train, rows), (b_pod, pod_rows)):
        t = {key: sum(r[key] for r in rs)
             for key in ("ms", "library_ms", "bound_ms", "dense_work_ms",
                         "scratch_bytes")}
        print(f"  B={b} one layer (7 projections): kernel {t['ms']:.4f} ms "
              f"= {t['ms'] / t['library_ms']:.2f}x dense torch.matmul "
              f"({t['library_ms']:.4f} ms), {t['ms'] / t['bound_ms']:.2f}x "
              f"the N:M bound ({t['bound_ms']:.4f} ms), "
              f"{t['ms'] / t['dense_work_ms']:.2f}x the dense work "
              f"({t['dense_work_ms']:.4f} ms, the dense-tile design's "
              f"operations; no 2:4 path yet); split-K scratch "
              f"{t['scratch_bytes']} bytes")
    print(f"  max abs err {worst:.3e} (tol {TOL:g} x |act|@|W|)")
    return worst, rows, pod_rows


def _compute_bitwise(a, b) -> bool:
    """Two compute trees (PregenOp or tensor leaves) equal bit for bit."""
    from repro_torch.core.operand import PregenOp
    from repro_torch.optim import sgd

    pairs = zip(sgd.tree_leaves(a), sgd.tree_leaves(b))
    for x, y in pairs:
        fields = (("bp", "ff", "vals", "idx", "mask")
                  if isinstance(x, PregenOp) else (None,))
        for fld in fields:
            u = x if fld is None else getattr(x, fld)
            t = y if fld is None else getattr(y, fld)
            if (u is None) != (t is None):
                return False
            if u is not None and not bits_equal(u.cpu(), t.cpu()):
                return False
    return True


def _masks(compute):
    from repro_torch.optim import sgd

    return [leaf.mask for leaf in sgd.tree_leaves(compute)
            if getattr(leaf, "mask", None) is not None]


def phase_train_small(dev, seed):
    """SMOKE-size training: three steps on the card and on the CPU."""
    from repro_torch.configs import qwen3_8b as C
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.synthetic import lm_stream
    from repro_torch.models import transformer_lm as T
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST

    cfg, sp = C.SMOKE, SparsityConfig(n=2, m=8, method="bdwp")
    opt = sgd.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
    params = T.init(cfg, seed=seed, device="cpu")
    states = {d: ST.train_state_from_params(
        sgd.tree_map(lambda _, t: t.to(d, copy=True), params), sp)
        for d in ("cpu", dev)}
    check(_compute_bitwise(states["cpu"]["compute"], states[dev]["compute"]),
          "small train: step-0 compute trees differ between card and CPU")
    print("  step-0 pre-generated compute trees bitwise equal")
    streams = {d: lm_stream(cfg.vocab, 2, 16, device=d, seed=seed)
               for d in states}
    worst = 0.0
    for step in range(3):
        loss = {}
        for d in states:
            _, batch = next(streams[d])
            states[d], met = ST.lm_train_step(states[d], batch, cfg=cfg,
                                              sp_cfg=sp, opt_cfg=opt)
            loss[d] = float(met["loss"])
        match = [float((a == b.cpu()).float().mean()) for a, b in zip(
            _masks(states["cpu"]["compute"]), _masks(states[dev]["compute"]))]
        diff = abs(loss["cpu"] - loss[dev])
        worst = max(worst, diff)
        print(f"  step {step}: loss card {loss[dev]:.6f} cpu "
              f"{loss['cpu']:.6f} |d| {diff:.3e} (tol "
              f"{SMALL_LOSS_ATOL[step]}); next masks equal: min "
              f"{min(match):.6f}, mean {sum(match) / len(match):.6f}")
        check(math.isfinite(loss[dev]), "small train: non-finite loss")
        check(diff <= SMALL_LOSS_ATOL[step],
              f"small train: step {step} losses disagree")
    return worst


def profile_train_step(step_fn, state, batch):
    """One training step under torch.profiler: wall, device busy and
    idle share, device and host time of forward / backward / sync /
    update, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    parts, kernels = {}, []
    # the backward runs on autograd's device thread, so its kernels do
    # not land under the train/backward range: its device time is the
    # busy time less forward and update
    for e in prof.key_averages():
        if e.key.startswith(RANGES):
            if not str(e.device_type).endswith("CUDA"):
                parts[e.key] = {
                    "host_ms": e.cpu_time_total / 1e3,
                    "device_ms": getattr(e, "device_time_total", 0) / 1e3}
            continue
        us = getattr(e, "self_device_time_total", 0)
        if us > 0 and str(e.device_type).endswith("CUDA"):
            kernels.append((us / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    argmax = sum(k[1] for k in kernels if "ArgMax" in k[2])
    share = {name: sum(k[0] for k in kernels if name in k[2])
             for name in ("nm_spmm", "fused_update", "grad_compress",
                          "grad_decompress_mean")}
    if "train/sync" in parts:
        # the profiler links none of the sync's ctypes launches to its
        # range; the two sync kernels are the only kernels it runs (its
        # buffers are allocations, and qwen3-8b has no ragged leaf)
        parts["train/sync"]["device_ms"] = (share["grad_compress"]
                                            + share["grad_decompress_mean"])
    if "train/backward" in parts:
        parts["train/backward"]["device_ms"] = busy - sum(
            parts[k]["device_ms"] for k in ("train/forward", "train/sync",
                                            "train/update")
            if k in parts)
    print(f"  profiled step: wall {wall_ms:.1f} ms (profiler on), device "
          f"busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}; "
          + ", ".join(f"{k} {v:.2f} ms ({v / busy:.3f} of busy)"
                      for k, v in share.items() if v))
    for key, t in sorted(parts.items()):
        print(f"    {key:16s} host {t['host_ms']:9.1f} ms  device "
              f"{t['device_ms']:9.1f} ms")
    for ms, count, key in kernels[:10]:
        print(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    print(f"    argmax reduce kernels in the step: {argmax}")
    return state, met, {"wall_ms": wall_ms, "device_busy_ms": busy,
                        "argmax_kernels": argmax,
                        "parts": parts, "kernel_ms": share,
                        "top_kernels": [list(k) for k in kernels[:15]]}


MLA_PATHS = tuple(("attn", n) for n in ("q_proj", "kv_down", "k_up", "v_up",
                                         "o_proj"))
FFN_NAMES = ("w_gate", "w_up", "w_down")
SSM_PATHS = (("ssm", "in_proj"), ("ssm", "out_proj"))


def ssm_site_paths(cfg):
    """An SSD block's weight sites: out_proj, and in_proj where BDWP 2:8
    prunes it (its F a multiple of 8: mamba2, not hymba's 6482)."""
    from repro_torch.core import bdwp
    from repro_torch.core.sparsity import SparsityConfig

    if not cfg.has_ssm:
        return ()
    sc, sp = cfg.ssm_cfg(), SparsityConfig(n=2, m=8, method="bdwp")
    shape = {"in_proj": (cfg.d_model, sc.d_in_proj),
             "out_proj": (sc.d_inner, cfg.d_model)}
    return tuple(p for p in SSM_PATHS if bdwp.pregen_site(
        f"blocks/ssm/{p[1]}/w", shape[p[1]], sp))


def proj_paths(cfg):
    """The weight sites of one block as key paths: attention (GQA's four
    projections or MLA's five) and the dense FFN, or an MoE block's three
    expert stacks and its shared experts' three matrices; an SSD block's
    sites after them (a mamba block has no others)."""
    if not cfg.has_attn:
        return ssm_site_paths(cfg)
    attn = MLA_PATHS if cfg.kv_lora is not None else PROJ_PATHS[:4]
    if cfg.moe is None:
        return attn + PROJ_PATHS[4:] + ssm_site_paths(cfg)
    shared = (tuple(("moe", "shared", n) for n in FFN_NAMES)
              if cfg.moe.n_shared else ())
    return attn + tuple(("moe", n) for n in FFN_NAMES) + shared


def prelude_paths(cfg):
    """The prelude's weight sites (none without one): attention and its
    dense FFN."""
    if not cfg.uses_scan_prelude:
        return ()
    attn = MLA_PATHS if cfg.kv_lora is not None else PROJ_PATHS[:4]
    return attn + PROJ_PATHS[4:]


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _site(leaf):
    """A block's weight site: the ``"w"`` of a leaf-dict, or a bare MoE
    stack."""
    return leaf["w"] if isinstance(leaf, dict) else leaf


def _packed_paths(paths):
    """The sites the element pack packs: leaf-dict weights but MLA's
    k_up/v_up (read raw by the absorbed decode); bare MoE leaves (the
    expert stacks, the shared experts) are served unpacked, as the
    reference's element pack leaves them."""
    return [p for p in paths if p[0] != "moe" and p[-1] not in ("k_up",
                                                               "v_up")]


def packed_per_forward(cfg) -> int:
    """Weights the element pack packs in a model, so nm_spmm launches a
    serving forward: 7 a dense block, an MoE block's attention
    projections, and the prelude's."""
    return (len(_packed_paths(prelude_paths(cfg)))
            + cfg.n_blocks * len(_packed_paths(proj_paths(cfg))))


def train_launches(cfg):
    """(nm_spmm launches, fused_update sites) of one packed BDWP step:
    every site's FF once in the forward, the blocks' again in their
    recompute (the prelude is not recomputed); one grouped fused_update
    over every site."""
    pre, blk = len(prelude_paths(cfg)), len(proj_paths(cfg))
    return pre + 2 * blk * cfg.n_blocks, pre + blk * cfg.n_blocks


def phase_train(dev, seed, cfg=None, rows=None, prefix=0):
    """A full-width depth-cut TRAIN config (qwen3-8b's unless ``cfg``
    names another): BDWP 2:8 packed pre-generation, ``rows`` (sequences,
    text tokens) a step, each sequence after ``prefix`` stub-frontend
    rows."""
    import functools

    from repro_torch.configs import qwen3_8b as C
    from repro_torch.core import sparsity as S
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.synthetic import lm_stream
    from repro_torch.kernels import fused_update as KF
    from repro_torch.kernels import nm_spmm as KS
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST

    cfg, sp = cfg or C.TRAIN, SparsityConfig(n=2, m=8, method="bdwp")
    rows = rows or TRAIN_ROWS
    opt = sgd.SGDConfig(lr=0.004, warmup_steps=2, total_steps=100)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = ST.init_train_state(cfg, sp, seed=seed, device=dev)
    torch.cuda.synchronize()
    print(f"  init {cfg.n_layers} layers + pre-generation: "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    step_fn = functools.partial(ST.lm_train_step, cfg=cfg, sp_cfg=sp,
                                opt_cfg=opt)
    data = lm_stream(cfg.vocab, *rows, device=dev, seed=seed, prefix=prefix,
                     d_model=cfg.d_model)
    # one grouped fused_update launch a step over the 7 x L sites (an MoE
    # layer: 4 attention projections and 3 expert stacks; deepseek: 8
    # prelude sites, then 5 MLA projections, 3 expert stacks and 3 shared
    # experts a block)
    spmm, sites = train_launches(cfg)
    want = (spmm, 1, sites)
    tokens = rows[0] * (prefix + rows[1])     # rows through the model
    KS.launches = KF.launches = KF.launched_sites = 0
    losses, times, per_step = [], [], []
    for _ in range(5):
        _, batch = next(data)
        c0 = (KS.launches, KF.launches, KF.launched_sites)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        per_step.append(tuple(a - b for a, b in zip(
            (KS.launches, KF.launches, KF.launched_sites), c0)))
        print(f"  step {len(losses) - 1}: loss {loss:.6f} lr "
              f"{float(met['lr']):.4g} {times[-1]:.1f} ms "
              f"({tokens / times[-1] * 1e3:.0f} tok/s); launches nm_spmm "
              f"{per_step[-1][0]} (want {want[0]}), fused_update "
              f"{per_step[-1][1]} over {per_step[-1][2]} sites (want "
              f"{want[1]} over {want[2]})")
        check(math.isfinite(loss), "train: non-finite loss")
        check(per_step[-1] == want, "train: launch counts")
    launches = {"nm_spmm": KS.launches, "fused_update": KF.launches,
                "fused_update_sites": KF.launched_sites}
    _, batch = next(data)
    state, met, prof = profile_train_step(step_fn, state, batch)
    check(math.isfinite(float(met["loss"])), "train: non-finite loss")
    check(prof["argmax_kernels"] == 0,
          "train: an argmax reduce (a plain N:M selection) is left")
    peak = torch.cuda.max_memory_allocated()
    # layer 0, the prelude, and where the step's one grouped launch runs
    # past 2^31 elements the last layer, whose sites lie beyond it
    checked = [("layer 0", ("blocks", 0), proj_paths(cfg))]
    if cfg.uses_scan_prelude:
        checked.append(("prelude", ("prelude",), prelude_paths(cfg)))
    site_elems = sum(_site(_at(state["master"], (*at, *path))).numel()
                     for at in [("prelude",)] * cfg.uses_scan_prelude
                     + [("blocks", i) for i in range(cfg.n_blocks)]
                     for path in (prelude_paths(cfg) if at == ("prelude",)
                                  else proj_paths(cfg)))
    if site_elems >= 2 ** 31:
        checked.append((f"layer {cfg.n_blocks - 1}",
                        ("blocks", cfg.n_blocks - 1), proj_paths(cfg)))
    for label, at, paths in checked:
        for path in paths:
            name = "/".join(path)
            op = _site(_at(state["compute"], (*at, *path)))
            w = _site(_at(state["master"], (*at, *path)))
            ff, bp_ax = w.ndim - 2, w.ndim - 1   # an expert stack: per expert
            vals, idx = S.nm_pack(w, 2, 8, axis=ff)
            check(torch.equal(op.vals.view(torch.int16),
                              vals.to(torch.bfloat16).view(torch.int16))
                  and torch.equal(op.idx, idx),
                  f"train: {label} {name} packed operand != nm_pack(master)")
            check(torch.equal(op.mask, S.nm_mask(w, 2, 8, axis=ff)),
                  f"train: {label} {name} stored mask != nm_mask(master)")
            bp = torch.where(S.nm_mask(w, 2, 8, axis=bp_ax), w, 0.0)
            check(bits_equal(op.bp, bp.to(torch.bfloat16)),
                  f"train: {label} {name} bp != the BP-axis mask's operand")
            del vals, idx, bp
    print("  " + ", ".join(c[0] for c in checked) + ": packed vals/idx == "
          "nm_pack(new master), stored mask == nm_mask(new master), bp == "
          "bf16(where(nm_mask(new master, BP axis), master, 0)), all "
          f"{len(proj_paths(cfg))} sites"
          + (" (the expert stacks per expert)" if cfg.moe else "")
          + f"; the step's grouped launch covers {site_elems} elements")
    steady = sorted(times[1:])
    ms = steady[len(steady) // 2]
    print(f"  {cfg.name} x{cfg.n_layers} layers, {rows[0]} x ("
          + (f"{prefix} prefix + " if prefix else "")
          + f"{rows[1]}) tokens: median of steps 1-4 "
          f"{ms:.1f} ms/step, {tokens / ms * 1e3:.0f} tokens/s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    check(peak < 80e9, f"train {cfg.name}: peak memory over 80 GB")
    return {"losses": losses, "step_ms": times, "ms_per_step": ms,
            "tokens_per_s": tokens / ms * 1e3, "launches": launches,
            "launches_per_step": per_step, "max_memory_allocated": peak,
            "profile": prof}


# phase 11 cases: (label, pods, K, n, m, gradient dtype, ties, shift):
# rows strided as the sync hands them over; ``shift`` > 0 moves g and
# err off a whole m-group, so only the scalar variant may take them
SYNC_CASES = [(f"P={p} K=4096 2:8 {dt}", p, 4096, 2, 8, dt, False, 0)
              for p in (1, 2, 3, 4) for dt in ("bf16", "fp32")]
SYNC_CASES += [
    ("bucket P=2 K=65536 2:8 bf16", 2, 65536, 2, 8, "bf16", False, 0),
    ("bucket P=2 K=65536 2:8 fp32", 2, 65536, 2, 8, "fp32", False, 0),
    ("ragged K=m", 2, 8, 2, 8, "bf16", False, 0),
    ("ragged K=4104 (513 groups)", 3, 4104, 2, 8, "fp32", False, 0),
    ("ragged tile K=528392", 2, 528392, 2, 8, "bf16", False, 0),
    ("2:4 K=4100", 2, 4100, 2, 4, "bf16", False, 0),
    ("1:8 K=4096", 4, 4096, 1, 8, "fp32", False, 0),
    ("4:16 K=4112", 2, 4112, 4, 16, "bf16", False, 0),
    ("3:8 K=8200", 2, 8200, 3, 8, "bf16", False, 0),
    ("ties 2:8 P=2 K=65536", 2, 65536, 2, 8, "bf16", True, 0),
    ("ties 2:4 P=3 K=4096", 3, 4096, 2, 4, "fp32", True, 0),
    ("misaligned 2:8 bf16", 2, 65536, 2, 8, "bf16", False, 1),
    ("misaligned 2:4 fp32", 3, 4100, 2, 4, "fp32", False, 1)]
SYNC_BUCKET = (2, 1 << 16)          # (pods, bucket_elems) of the reference
SYNC_PODS = 2
SYNC_ROWS = (4, 512)                # 2 pods x (2 x 512) tokens a step
# phase 11's leaf shapes: (name, numel) of the TRAIN_SYNC leaves the
# sync hands over whole (one launch each): a layer's w_gate, and the
# embedding table (the largest)
SYNC_LEAVES = [("w_gate", 4096 * 12288), ("embed", 152064 * 4096)]
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def sync_case(gen, pods, k, m, dtype, ties, dev, shift=0):
    """(g, err) as the sync feeds the compress kernel: rows strided (a
    leaf inside a wider tensor, a column range of the residual), g in its
    dtype, err fp32, both ``shift`` elements past a whole m-group;
    ``ties`` draws half-integers (no negative zeros, which the plain
    version keeps and the reference's Pallas kernel does not)."""
    g = torch.randn((pods, k + 2 * m), generator=gen, device=dev)
    if ties:
        g = torch.round(g * 2) / 2 + 0.0
    g = g.to(DTYPES[dtype])[:, m + shift:m + shift + k]
    err = torch.randn((pods, k + m), generator=gen, device=dev) * 0.1
    return g, err[:, shift:shift + k]


def _copy_view(t):
    """A copy of the 2-D view ``t`` with its strides and storage offset
    (so with its alignment)."""
    size = t.storage_offset() + t.stride(0) * (t.shape[0] - 1) + t.shape[1]
    base = torch.empty(size, dtype=t.dtype, device=t.device)
    return base.as_strided(t.shape, t.stride(), t.storage_offset()).copy_(t)


def compress_bound_ms(pods, k, n, m, gbytes):
    """Bytes over 3.35 TB/s: g read, err read, err' written, vals and idx
    written (n/m of an element, 2 + 1 B)."""
    return pods * k * (gbytes + 8 + 3 * n / m) / HBM_BYTES_PER_S * 1e3


def mean_bound_ms(pods, k, n, m, obytes):
    """Bytes over 3.35 TB/s: P payload rows read (n/m x 3 B per output
    element each), the mean written (``obytes`` per element)."""
    return k * (pods * 3 * n / m + obytes) / HBM_BYTES_PER_S * 1e3


def _variant_counts(K):
    return {op: dict(v) for op, v in K.variant_launches.items()}


def _check_sync_case(K, ref, label, g, err, n, m, variants):
    """Both kernels in each of ``variants`` against the plain versions,
    bitwise (err' in place, the mean in fp32 and in g's dtype), and
    decode(vals, idx) + err' == g + err.  Returns (the largest
    difference, 0 when bitwise; {kernel: the variants its last launch
    took})."""
    want = ref.ref_grad_compress(g, err, n, m)
    plain_mean = ref.ref_grad_decompress_mean(want[0], want[1], n, m)
    worst = 0.0
    for variant in variants:
        e = _copy_view(err)
        before = _variant_counts(K)
        got = K.grad_compress(g, e, n, m, out_err=e, variant=variant)
        decoded = ref.decompress_nm(got[0].float(), got[1], n, m)
        torch.cuda.synchronize()
        for name, a, b in zip(("vals", "idx", "err'"), got, want):
            check(bits_equal(a, b), f"grad_compress {label} ({variant}): "
                  f"{name} not bitwise equal to the plain version")
            worst = max(worst, float((a.float() - b.float()).abs().max()))
        check(bits_equal(decoded.add_(got[2]),
                         g.to(torch.float32, copy=True).add_(err)),
              f"grad_compress {label} ({variant}): decode + err' != g + err")
        del decoded
        for out_dtype in (torch.float32, g.dtype):
            out = torch.empty(g.shape[1], dtype=out_dtype, device=g.device)
            mean = K.grad_decompress_mean(got[0], got[1], n, m, out=out,
                                          variant=variant)
            torch.cuda.synchronize()
            want_mean = plain_mean.to(out_dtype)
            check(bits_equal(mean, want_mean),
                  f"grad_decompress_mean {label} ({variant}) -> "
                  f"{out_dtype}: not bitwise equal to the plain version")
            worst = max(worst, float((mean.float()
                                      - want_mean.float()).abs().max()))
        after = _variant_counts(K)
        took = {op: [v for v in after[op] if after[op][v] > before[op][v]]
                for op in after}
        check(variant == "auto" or all(t == [variant] for t in took.values()),
              f"{label}: asked for {variant}, launched {took}")
    return worst, took


def phase_sync_kernels(dev, gen):
    """grad_compress and grad_decompress_mean in both variants vs plain
    (bitwise), the EF identity on the card, then device times at the
    sync's leaf shapes and at the reference's bucket."""
    from repro_torch.kernels import grad_compress as K
    from repro_torch.kernels import ref

    worst = 0.0
    for label, pods, k, n, m, dt, ties, shift in SYNC_CASES:
        g, err = sync_case(gen, pods, k, m, dt, ties, dev, shift)
        variants = ("auto", "scalar") if shift else ("vector", "scalar")
        w, took = _check_sync_case(K, ref, label, g, err, n, m, variants)
        if shift:   # off a whole m-group: auto took the scalar variant
            check(took["grad_compress"] == ["scalar"],
                  f"{label}: auto launched {took}, not the scalar variant")
        worst = max(worst, w)
        print(f"  {label:30s} {' and '.join(variants)}: vals, idx, err', "
              "mean bitwise equal; decode + err' == g + err bitwise")
    rows = []
    # the sync's leaves, whole, as it launches them (cold by their size)
    for name, numel in SYNC_LEAVES:
        g, err = sync_case(gen, 2, numel, 8, "bf16", False, dev)
        worst = max(worst, _check_sync_case(
            K, ref, f"leaf {name} (2, {numel})", g, err, 2, 8,
            ("vector", "scalar"))[0])
        torch.cuda.empty_cache()
        vals, idx, _ = K.grad_compress(g, _copy_view(err), 2, 8)
        out_v = torch.empty(numel, dtype=torch.bfloat16, device=dev)
        # the median of three graph replays of each, the variants in
        # turns (vector, scalar, scalar, vector, vector, scalar)
        runs = {}
        iters = 20 if name == "w_gate" else 5
        for variant in ("vector", "scalar", "scalar", "vector", "vector",
                        "scalar"):
            runs.setdefault(f"grad_compress_{variant}", []).append(time_ms(
                lambda i: K.grad_compress(g, err, 2, 8, out_err=err,
                                          variant=variant), 1, iters=iters))
            runs.setdefault(f"grad_decompress_mean_{variant}", []).append(
                time_ms(lambda i: K.grad_decompress_mean(
                    vals, idx, 2, 8, out=out_v, variant=variant), 1,
                    iters=iters))
        times = {k: sorted(v)[1] for k, v in runs.items()}
        if name == "w_gate":
            times["grad_compress_plain"] = time_ms(
                lambda i: ref.ref_grad_compress(g, err, 2, 8), 1, iters=2)
            times["grad_decompress_mean_plain"] = time_ms(
                lambda i: out_v.copy_(ref.ref_grad_decompress_mean(
                    vals, idx, 2, 8)), 1, iters=2)
        b_c = compress_bound_ms(2, numel, 2, 8, 2)
        b_m = mean_bound_ms(2, numel, 2, 8, 2)
        row = {"leaf": name, "dtype": "bf16", "P": 2, "K": numel}
        for op, bound in (("grad_compress", b_c),
                          ("grad_decompress_mean", b_m)):
            row[op] = {"ms": times[f"{op}_vector"],
                       "ms_runs": runs[f"{op}_vector"],
                       "scalar_ms": times[f"{op}_scalar"],
                       "scalar_ms_runs": runs[f"{op}_scalar"],
                       "plain_ms": times.get(f"{op}_plain"),
                       "bound_ms": bound,
                       "bound_share": bound / times[f"{op}_vector"]}
        rows.append(row)
        plain = (f"; plain {times['grad_compress_plain']:.3f} / "
                 f"{times['grad_decompress_mean_plain']:.3f} ms"
                 if name == "w_gate" else "; plain not timed at this size")
        t_c, t_m = (times["grad_compress_vector"],
                    times["grad_decompress_mean_vector"])
        print(f"  leaf {name} (2, {numel}) bf16 g, 2:8: grad_compress "
              f"{t_c:.4f} ms (bound {b_c:.4f} ms, bytes: {b_c / t_c:.0%}; "
              f"scalar variant {times['grad_compress_scalar']:.4f} ms); "
              f"grad_decompress_mean {t_m:.4f} ms (bound {b_m:.4f} ms: "
              f"{b_m / t_m:.0%}; scalar "
              f"{times['grad_decompress_mean_scalar']:.4f} ms){plain}")
        del g, err, vals, idx, out_v
        torch.cuda.empty_cache()
    # the reference's bucket, (2, 1 << 16), cycling cold copies
    pods, k = SYNC_BUCKET
    for dt in ("bf16", "fp32"):
        gbytes = 2 if dt == "bf16" else 4
        copies = max(2, -(-2 * L2_BYTES // (pods * k * (gbytes + 8))))
        sets = [sync_case(gen, pods, k, 8, dt, False, dev)
                for _ in range(copies)]
        packs = [K.grad_compress(g, e, 2, 8)[:2] for g, e in sets]
        # the mean in the gradient's dtype, as the sync writes it
        outs = [torch.empty(k, dtype=DTYPES[dt], device=dev)
                for _ in range(copies)]
        t = {}
        for variant in ("vector", "scalar"):
            t[f"c_{variant}"] = time_ms(lambda i: K.grad_compress(
                *sets[i], 2, 8, variant=variant), copies, iters=copies)
            t[f"m_{variant}"] = time_ms(lambda i: K.grad_decompress_mean(
                *packs[i], 2, 8, out=outs[i], variant=variant), copies,
                iters=copies)
        t_cp = time_ms(lambda i: ref.ref_grad_compress(*sets[i], 2, 8),
                       copies, iters=copies)
        t_mp = time_ms(lambda i: outs[i].copy_(
            ref.ref_grad_decompress_mean(*packs[i], 2, 8)), copies,
            iters=copies)
        b_c = compress_bound_ms(pods, k, 2, 8, gbytes)
        b_m = mean_bound_ms(pods, k, 2, 8, gbytes)
        rows.append({"leaf": "bucket", "dtype": dt, "P": pods, "K": k,
                     "grad_compress": {"ms": t["c_vector"],
                                       "scalar_ms": t["c_scalar"],
                                       "plain_ms": t_cp, "bound_ms": b_c},
                     "grad_decompress_mean": {"ms": t["m_vector"],
                                              "scalar_ms": t["m_scalar"],
                                              "plain_ms": t_mp,
                                              "bound_ms": b_m}})
        print(f"  bucket ({pods}, {k}) {dt} g: grad_compress "
              f"{1e3 * t['c_vector']:.2f} us (scalar {1e3 * t['c_scalar']:.2f}"
              f" us; bound {1e3 * b_c:.2f} us; plain {1e3 * t_cp:.1f} us); "
              f"grad_decompress_mean {1e3 * t['m_vector']:.2f} us (scalar "
              f"{1e3 * t['m_scalar']:.2f} us; bound {1e3 * b_m:.2f} us; "
              f"plain {1e3 * t_mp:.1f} us)")
        del sets, packs, outs
    return worst, rows


def _sync_shapes(cfg):
    """Leaf shapes of ``cfg``'s master tree, from a tree on the meta
    device (no memory)."""
    from repro_torch.models import transformer_lm as T
    from repro_torch.optim import sgd

    tree = T.init_shell(cfg, None, device="meta")
    tree["blocks"] = list(T.iter_blocks(cfg, None, device="meta"))
    return tree, [tuple(x.shape) for x in sgd.tree_leaves(tree)]


def bucket_sync(grads, err, cfg):
    """The reference's launch plan on the card: ``cross_pod_sync``'s work
    launched chunk by chunk over ``plan_sync``'s buckets (one
    ``grad_compress`` and one ``grad_decompress_mean`` per bucket), the
    port's sync before it launched once per leaf.  Returns (the mean of
    each compressible leaf, None for a ragged one, in ``tree_leaves``
    order; ``err``, updated in place)."""
    from repro_torch.kernels import ops
    from repro_torch.optim import compress as CS
    from repro_torch.optim import sgd

    leaves = sgd.tree_leaves(grads)
    pods = leaves[0].shape[0]
    plan = CS.plan_sync([tuple(x.shape[1:]) for x in leaves],
                        cfg.bucket_elems, cfg.m)
    outs = [None if off is None else torch.empty(
        x.shape[1:], dtype=x.dtype, device=err.device)
        for x, off in zip(leaves, plan.offsets)]
    for (i,), s, e in plan.chunks:   # trees without layer stacks
        col = plan.offsets[i]
        vals, idx, _ = ops.grad_compress(
            leaves[i].reshape(pods, -1)[:, s:e], err[:, col + s:col + e],
            cfg.n, cfg.m)
        ops.grad_decompress_mean(vals, idx, cfg.n, cfg.m,
                                 outs[i].view(-1)[s:e])
    return outs, err


def phase_sync_alone(dev, seed):
    """cross_pod_sync at qwen3-8b TRAIN_SYNC leaf shapes, P = 2, bf16
    gradients: one launch of each kernel per leaf (47), against the
    reference's 1 << 16 buckets launched chunk by chunk (30,801): mean
    gradients and residuals bitwise equal."""
    from repro_torch.configs import qwen3_8b as C
    from repro_torch.kernels import grad_compress as KG
    from repro_torch.optim import compress as CS
    from repro_torch.optim import sgd

    tree, shapes = _sync_shapes(C.TRAIN_SYNC)
    pods = SYNC_PODS
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    grads = sgd.tree_map(lambda _, x: (torch.randn(
        (pods, *x.shape), generator=gen, device=dev) * 1e-3).to(
            torch.bfloat16), tree)
    width = CS.err_state_elems(tree, 8)
    cfg = CS.GradCompressConfig(n=2, m=8, bucket_elems=SYNC_BUCKET[1])
    plan = CS.plan_sync(shapes, cfg.bucket_elems, 8)

    def residual():   # drawn in place: no 16 GB temporary
        g = torch.Generator(device=dev).manual_seed(seed + 13)
        return torch.empty((pods, width), device=dev).normal_(
            0.0, 1e-4, generator=g)

    runs = {"per leaf": (CS.cross_pod_sync, len(plan.leaves)),
            "1 << 16 buckets": (bucket_sync, plan.n_buckets)}
    results, report = {}, {}
    for label, (sync, want) in runs.items():
        times = []
        for rep in range(2):   # the second run's results are kept
            err = residual()
            torch.cuda.synchronize()
            c0, v0 = dict(KG.launches), _variant_counts(KG)
            t0 = time.perf_counter()
            out, err = sync(grads, err, cfg)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            got = {k: KG.launches[k] - c0[k] for k in c0}
            check(got == dict.fromkeys(c0, want),
                  f"sync alone ({label}): launches {got} != {want} each")
            vec = {op: KG.variant_launches[op]["vector"] - v0[op]["vector"]
                   for op in v0}
            check(vec == got, f"sync alone ({label}): vector-variant "
                  f"launches {vec} != all {got}")
            if rep == 1:
                kept = out if sync is bucket_sync else sgd.tree_leaves(out)
                results[label] = ([kept[i] for i, _, _ in plan.leaves], err)
            del out, err
        report[label] = {"launches_each": want, "ms": times}
        print(f"  {label}: {want} launches of each kernel (all vector "
              f"variant); sync {times[0]:.1f} ms, again {times[1]:.1f} ms")
        torch.cuda.empty_cache()
    (oa, ea), (ob, eb) = results.values()
    check(bits_equal(ea, eb), "sync alone: residuals differ between the "
          "per-leaf sync and the bucket walk")
    for a, b in zip(oa, ob):
        check(bits_equal(a, b), "sync alone: mean gradients differ between "
              "the per-leaf sync and the bucket walk")
    print("  mean gradients and residuals bitwise equal: per leaf == "
          "1 << 16 buckets")
    peak = torch.cuda.max_memory_allocated()
    print(f"  residual ({pods}, {width}) fp32; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB")
    del results, grads
    return report


class SyncSpy:
    """Wraps ``optim.compress.cross_pod_sync`` for one call: keeps CPU
    copies of its pod-stacked gradients and input residual (the residual
    is updated in place) and of its outputs."""

    def __init__(self, compress_mod):
        self.mod, self.seen = compress_mod, None
        self.real = compress_mod.cross_pod_sync

    def __enter__(self):
        def spy(grads, err, cfg, **kw):
            from repro_torch.optim import sgd

            cpu = sgd.tree_map(lambda _, x: x.to("cpu", copy=True), grads)
            err_in = err.to("cpu", copy=True)
            out, new_err = self.real(grads, err, cfg, **kw)
            self.seen = (cpu, err_in, cfg, sgd.tree_map(
                lambda _, x: x.to("cpu", copy=True), out),
                new_err.to("cpu", copy=True))
            return out, new_err

        self.mod.cross_pod_sync = spy
        return self

    def __exit__(self, *exc):
        self.mod.cross_pod_sync = self.real


def phase_train_sync_small(dev, seed):
    """SMOKE compressed training, P = 2: three steps on the card and on
    the CPU; each step's card sync against the CPU sync of the same
    pod-stacked gradients, bitwise."""
    from repro_torch.configs import qwen3_8b as C
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.synthetic import lm_stream
    from repro_torch.models import transformer_lm as T
    from repro_torch.optim import compress as CS
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST

    cfg, sp = C.SMOKE, SparsityConfig(n=2, m=8, method="bdwp")
    opt = sgd.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
    params = T.init(cfg, seed=seed, device="cpu")
    states = {d: ST.train_state_from_params(
        sgd.tree_map(lambda _, t: t.to(d, copy=True), params), sp,
        compress=True, n_pods=SYNC_PODS) for d in ("cpu", dev)}
    streams = {d: lm_stream(cfg.vocab, 4, 16, device=d, seed=seed)
               for d in states}
    worst = 0.0
    for step in range(3):
        loss = {}
        for d in states:
            _, batch = next(streams[d])
            with SyncSpy(CS) as spy:
                states[d], met = ST.lm_train_step(
                    states[d], batch, cfg=cfg, sp_cfg=sp, opt_cfg=opt,
                    compress=True, n_pods=SYNC_PODS)
            loss[d] = float(met["loss"])
            if d == dev:
                grads, err_in, gc, out, new_err = spy.seen
                want, want_err = CS.cross_pod_sync(grads, err_in, gc)
                check(bits_equal(new_err, want_err),
                      f"small sync: step {step} card residual != CPU's")
                for a, b in zip(sgd.tree_leaves(out), sgd.tree_leaves(want)):
                    check(bits_equal(a, b), f"small sync: step {step} card "
                          "mean gradient != CPU's")
        diff = abs(loss["cpu"] - loss[dev])
        worst = max(worst, diff)
        print(f"  step {step}: loss card {loss[dev]:.6f} cpu "
              f"{loss['cpu']:.6f} |d| {diff:.3e} (tol "
              f"{SMALL_LOSS_ATOL[step]}); card sync == CPU sync of the "
              "card's gradients, bitwise")
        check(math.isfinite(loss[dev]), "small sync: non-finite loss")
        check(diff <= SMALL_LOSS_ATOL[step],
              f"small sync: step {step} losses disagree")
    return worst


def phase_train_sync(dev, seed):
    """qwen3-8b TRAIN_SYNC: compressed sync of 2 pods, 2:8 bdwp packed."""
    import functools

    from repro_torch.configs import qwen3_8b as C
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.synthetic import lm_stream
    from repro_torch.kernels import fused_update as KF
    from repro_torch.kernels import grad_compress as KG
    from repro_torch.kernels import nm_spmm as KS
    from repro_torch.kernels import ref
    from repro_torch.optim import compress as CS
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST

    cfg, sp = C.TRAIN_SYNC, SparsityConfig(n=2, m=8, method="bdwp")
    opt = sgd.SGDConfig(lr=0.004, warmup_steps=2, total_steps=100)
    gc = CS.GradCompressConfig.from_sparsity(sp)
    _, shapes = _sync_shapes(cfg)
    plan = CS.plan_sync(shapes, gc.bucket_elems, gc.m)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = ST.init_train_state(cfg, sp, seed=seed, device=dev,
                                compress=True, n_pods=SYNC_PODS)
    torch.cuda.synchronize()
    print(f"  init {cfg.n_layers} layers + pre-generation + residual "
          f"{tuple(state['err'].shape)}: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    step_fn = functools.partial(ST.lm_train_step, cfg=cfg, sp_cfg=sp,
                                opt_cfg=opt, compress=True, n_pods=SYNC_PODS)
    data = lm_stream(cfg.vocab, *SYNC_ROWS, device=dev, seed=seed)
    want = {"nm_spmm": 2 * 7 * cfg.n_layers * SYNC_PODS,
            "fused_update": 1, "fused_update_sites": 7 * cfg.n_layers,
            "grad_compress": len(plan.leaves),
            "grad_decompress_mean": len(plan.leaves)}
    tokens = SYNC_ROWS[0] * SYNC_ROWS[1]

    def counts():
        return {"nm_spmm": KS.launches, "fused_update": KF.launches,
                "fused_update_sites": KF.launched_sites, **KG.launches,
                **{f"{op}/vector": v["vector"]
                   for op, v in KG.variant_launches.items()}}

    want.update({f"{op}/vector": want[op] for op in KG.launches})
    KS.launches = KF.launches = KF.launched_sites = 0
    KG.launches.update(dict.fromkeys(KG.launches, 0))
    for v in KG.variant_launches.values():
        v.update(dict.fromkeys(v, 0))
    losses, times, per_step, spied = [], [], [], None
    for i in range(5):
        _, batch = next(data)
        c0 = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 1:   # keep layer 0's w_gate gradient and residual
            spied = _spy_leaf(CS, state, plan)
            state, met = step_fn(state, batch)
            CS.cross_pod_sync = spied["real"]
        else:
            state, met = step_fn(state, batch)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        got = {k: v - c0[k] for k, v in counts().items()}
        per_step.append(got)
        print(f"  step {i}: loss {loss:.6f} lr {float(met['lr']):.4g} "
              f"{times[-1]:.1f} ms ({tokens / times[-1] * 1e3:.0f} tok/s); "
              f"launches {got}")
        check(math.isfinite(loss), "train sync: non-finite loss")
        check(got == want, f"train sync: launch counts {got} != {want}")
    launches = counts()
    # the EF identity on layer 0's w_gate, from step 1's sync
    g, e_in, e_out = spied["g"], spied["err_in"], spied["err_out"]
    vals, idx, e_new = KG.grad_compress(g, e_in.clone(), 2, 8)
    decoded = ref.decompress_nm(vals.float(), idx, 2, 8)
    torch.cuda.synchronize()
    check(bits_equal(e_new, e_out), "train sync: w_gate residual != a "
          "fresh compress of its gradient")
    check(bits_equal(decoded + e_new, g.float() + e_in),
          "train sync: decode(payload) + err' != g + err on w_gate")
    print(f"  layer 0 w_gate {tuple(g.shape)}: the step's residual == a "
          "fresh grad_compress; decode(payload) + err' == g + err, bitwise")
    del spied, g, e_in, e_out, vals, idx, e_new, decoded
    _, batch = next(data)
    state, met, prof = profile_train_step(step_fn, state, batch)
    check(math.isfinite(float(met["loss"])), "train sync: non-finite loss")
    check(prof["argmax_kernels"] == 0,
          "train sync: an argmax reduce (a plain N:M selection) is left")
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(times[1:])
    ms = steady[len(steady) // 2]
    print(f"  {cfg.name} x{cfg.n_layers} layers, {SYNC_PODS} pods: median "
          f"of steps 1-4 {ms:.1f} ms/step, {tokens / ms * 1e3:.0f} "
          f"tokens/s; {len(plan.leaves)} leaves (launches of each sync "
          f"kernel) a sync; max_memory_allocated {peak / 2**30:.2f} GiB")
    del state
    return {"losses": losses, "step_ms": times, "ms_per_step": ms,
            "tokens_per_s": tokens / ms * 1e3, "launches": launches,
            "launches_per_step": per_step, "leaves": len(plan.leaves),
            "max_memory_allocated": peak, "profile": prof}


def _spy_leaf(compress_mod, state, plan):
    """Wrap cross_pod_sync for one call to keep layer 0's w_gate pod
    gradients and its residual columns before and after the sync."""
    from repro_torch.optim import sgd

    real = compress_mod.cross_pod_sync
    kept = {"real": real}

    def spy(grads, err, cfg, **kw):
        leaves = sgd.tree_leaves(grads)
        target = grads["blocks"][0]["ffn"]["w_gate"]["w"]
        i = next(j for j, x in enumerate(leaves) if x is target)
        col, numel = plan.offsets[i], target[0].numel()
        kept["g"] = target.reshape(target.shape[0], -1).clone()
        kept["err_in"] = err[:, col:col + numel].clone()
        out = real(grads, err, cfg, **kw)
        kept["err_out"] = err[:, col:col + numel].clone()
        return out

    compress_mod.cross_pod_sync = spy
    return kept


def phase_small(dev, seed):
    """SMOKE-size model on the card vs the same port on the CPU."""
    from repro_torch.configs import qwen3_8b as C
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.models import transformer_lm as T
    from repro_torch.serve.packed_params import pack_tree_element
    from repro_torch.train import step as ST

    cfg, sp = C.SMOKE, SparsityConfig(n=2, m=8, method="bdwp")
    params = T.init(cfg, seed=seed, device="cpu", dtype=torch.bfloat16)
    on = {d: pack_tree_element(params, sp, device=d)[0] for d in ("cpu", dev)}
    toks = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab, (2, 12)))
    last = [4, 8]
    worst = 0.0
    logits, caches = {}, {}
    for d, p in on.items():
        logits[d], caches[d] = ST.lm_prefill_step(
            p, {"tokens": toks.to(d)}, cfg=cfg, sp_cfg=sp, last_index=last)
    pos = torch.tensor([5, 9])
    for step in range(3):
        a, b = logits["cpu"], logits[dev].cpu()
        check(bool(torch.isfinite(b[..., :cfg.vocab]).all()),
              "small: non-finite logits on the card")
        worst = max(worst, float((a - b).abs().max()))
        if step == 2:
            break
        tok = torch.argmax(a[:, -1, :cfg.vocab], -1)[:, None]
        for d, p in on.items():
            logits[d], caches[d] = ST.lm_decode_step(
                p, caches[d], tok.to(d), (pos + step).to(d), cfg=cfg,
                sp_cfg=sp)
    print(f"  SMOKE prefill + 2 decode steps, card vs CPU: "
          f"max |dlogit| = {worst:.3e} (tol {SMALL_ATOL})")
    check(worst <= SMALL_ATOL, "small: card and CPU logits disagree")


def profile_steps(step, steps: int, kernel_keys) -> dict:
    """torch.profiler over ``steps`` calls of ``step()``: device-busy ms per
    step (sum of kernel self times; one stream, so kernels do not
    overlap), the part of it in kernels whose name holds one of
    ``kernel_keys``, host wall ms per step under the profiler, and the top
    kernels and host ops."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, host, parts = [], [], {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if e.key.startswith(RANGES):   # a range's span, no kernel
            if not str(e.device_type).endswith("CUDA"):
                parts[e.key] = {"host_ms": e.cpu_time_total / steps / 1e3}
            continue
        if us > 0 and str(e.device_type).endswith("CUDA"):
            kernels.append((us / steps / 1e3, e.count // steps, e.key))
        elif e.self_cpu_time_total > 0:
            host.append((e.self_cpu_time_total / steps / 1e3,
                         e.count // steps, e.key))
    kernels.sort(reverse=True)
    host.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    mine = sum(k[0] for k in kernels if any(s in k[2] for s in kernel_keys))
    wall_ms = 1e3 * wall / steps
    print(f"  profiled {steps} decode steps: wall {wall_ms:.2f} ms/step "
          f"(profiler on), device busy {busy:.3f} ms/step, "
          f"{'/'.join(kernel_keys)} {mine:.3f} ms/step "
          f"({mine / busy if busy else float('nan'):.3f} of busy), "
          f"device idle share "
          f"{(1 - busy / wall_ms) if busy else float('nan'):.3f}")
    for ms, count, key in kernels[:8]:
        print(f"    {ms:8.4f} ms/step  x{count:<5d} {key[:90]}")
    print(f"  host: {sum(h[0] for h in host):.2f} ms/step of self CPU time "
          f"in {sum(h[1] for h in host)} op calls; top:")
    for ms, count, key in host[:8]:
        print(f"    {ms:8.4f} ms/step  x{count:<5d} {key[:90]}")
    return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
            "kernel_ms_per_step": mine, "parts": parts,
            "top_kernels": [list(k) for k in kernels[:12]],
            "top_host_ops": [list(h) for h in host[:12]]}


def profile_decode(engine, prompts, steps: int = 5) -> dict:
    """``profile_steps`` over ``steps`` engine decode steps with 4 running
    requests."""
    engine.reset()
    for p in prompts[:4]:
        engine.submit(p, max_new_tokens=steps + 2)
    engine.step()                 # admission: prefills + one decode
    prof = profile_steps(engine.step, steps, ("nm_spmm",))
    engine.run()
    return prof


def timed_draws(blocks, clock: list):
    """Yield ``blocks``, adding the wall time of drawing each (synchronized)
    to ``clock[0]``."""
    it = iter(blocks)
    while True:
        t0 = time.perf_counter()
        try:
            block = next(it)
        except StopIteration:
            return
        torch.cuda.synchronize()
        clock[0] += time.perf_counter() - t0
        yield block


SERVE_LENS, SERVE_NEW = (5, 32, 17, 9, 26, 12), (8, 24, 16, 12, 20, 10)


def pack_full(dev, seed, cfg, sp):
    """``cfg``'s bf16 weights from a seed, drawn and 2:8 u4-packed layer
    by layer on the card: (store, nm_compact launches, by variant,
    pack seconds without the draws, draw seconds)."""
    from repro_torch.kernels import nm_compact as KC
    from repro_torch.models import transformer_lm as T
    from repro_torch.serve.packed_params import PackedParamStore

    gen = T.generator(seed, dev)
    t0 = time.perf_counter()
    shell = T.init_shell(cfg, gen, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    shell_s, draws = time.perf_counter() - t0, [0.0]
    KC.launches = 0
    KC.variant_launches.update(dict.fromkeys(KC.VARIANTS, 0))
    t0 = time.perf_counter()
    store = PackedParamStore.pack_layerwise(
        shell, timed_draws(T.iter_blocks(cfg, gen, device=dev,
                                         dtype=torch.bfloat16), draws),
        sp, idx_bits=4, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0 - draws[0]
    compact, compact_variants = KC.launches, dict(KC.variant_launches)
    want = packed_per_forward(cfg)
    print(f"  init {shell_s + draws[0]:.1f} s + pack {pack_s:.4f} s "
          f"({cfg.n_layers} layers, nm_compact launches {compact}, want "
          f"{want}, by variant {compact_variants}), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(compact == want, f"serve {cfg.name}: nm_compact launch count")
    check(compact_variants["vector"] == compact, f"serve {cfg.name}: an "
          "element-pack launch missed the vector variant")
    return store, compact, compact_variants, pack_s


def phase_serve(dev, seed, cfg=None, lens=SERVE_LENS, new=SERVE_NEW,
                serve_kw=None, then=None):
    """A FULL config (qwen3-8b's unless ``cfg`` names another), packed 2:8
    u4, through the engine: prompts of ``lens`` tokens asking for ``new``
    tokens each, ``ServeConfig(**serve_kw)``; ``then(store, prompts)``,
    if given, runs on the packed store last (its result under
    "then")."""
    from repro_torch.configs import qwen3_8b as C
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.train import step as ST

    cfg, sp = cfg or C.FULL, SparsityConfig(n=2, m=8, method="bdwp")
    serve_kw = serve_kw or dict(n_slots=4, prompt_bucket=32, max_len=96)
    torch.cuda.reset_peak_memory_stats()
    store, compact, compact_variants, pack_s = pack_full(dev, seed, cfg, sp)
    engine = ServeEngine(store, cfg, sp, ServeConfig(packed=True, **serve_kw),
                         device=dev)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]

    engine.submit(prompts[0][:3], max_new_tokens=2)      # warm-up
    engine.run()
    engine.reset()
    torch.cuda.synchronize()

    K.launches = 0
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=m) for p, m in zip(prompts, new)]
    batched = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launches
    st = engine.stats()
    want = packed_per_forward(cfg) * (st["prefill_steps"]
                                      + st["decode_steps"])
    print(f"  batched: {len(rids)} requests, {st['decoded_tokens']} tokens, "
          f"{st['prefill_steps']} prefills, {st['decode_steps']} decode "
          f"steps in {wall:.3f} s: {st['decoded_tokens'] / wall:.1f} tok/s, "
          f"{1e3 * wall / st['steps']:.2f} ms/step; nm_spmm launches "
          f"{launches} (want {want})")
    check(launches > 0 and launches == want, "serve: nm_spmm launch count")
    check([len(batched[r]) for r in rids] == list(new), "serve: lengths")

    for r, p, m in zip(rids, prompts, new):
        engine.reset()
        rid = engine.submit(p, max_new_tokens=m)
        check(engine.run()[rid] == batched[r],
              f"serve: request {r} batched stream != solo stream")
    print(f"  all {len(rids)} batched streams equal their solo streams")

    toks = torch.tensor([prompts[1]], device=dev)
    logits, _ = ST.lm_prefill_step(store.params, {"tokens": toks}, cfg=cfg,
                                   sp_cfg=sp, last_index=[len(prompts[1]) - 1])
    check(tuple(logits.shape) == (1, 1, cfg.padded_vocab), "serve: shape")
    check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          "serve: non-finite logits")
    check(int(torch.argmax(logits[0, -1, :cfg.vocab])) == batched[rids[1]][0],
          "serve: prefill argmax != first streamed token")
    prof = profile_decode(engine, prompts)
    peak = torch.cuda.max_memory_allocated()
    report = engine.hbm_report()
    print(f"  max_memory_allocated {peak / 2**30:.2f} GiB")
    print("  hbm_report " + json.dumps(report))
    check(peak < 80e9, f"serve {cfg.name}: peak memory over 80 GB")
    extra = then(store, prompts) if then is not None else None
    return {"launches": launches, "compact_launches": compact, "then": extra,
            "compact_variants": compact_variants,
            "pack_s": pack_s, "tok_per_s": st["decoded_tokens"] / wall,
            "ms_per_step": 1e3 * wall / st["steps"], "wall_s": wall,
            "stats": st, "max_memory_allocated": peak, "hbm_report": report,
            "profile": prof}

# phase 15 nm_compact cases beyond the seven weights: (label, R, K, n, m,
# idx_bits, dtype); the "ties" cases draw small integers, -0 included
COMPACT_RAGGED = [
    ("odd Kc u4 1:8 K=56", 5, 56, 1, 8, 4, "fp32"),
    ("odd Kc u4 3:8 K=24", 9, 24, 3, 8, 4, "bf16"),
    ("K=m", 3, 8, 2, 8, 4, "bf16"), ("2:4 K=64", 7, 64, 2, 4, 4, "fp32"),
    ("1:8 K=4096 u4", 2, 4096, 1, 8, 4, "fp32"),
    ("1:8 K=4096 u8", 3, 4096, 1, 8, 8, "bf16"),
    ("4:16 K=512", 4, 512, 4, 16, 4, "bf16"),
    ("2:4 K=100 u8", 3, 100, 2, 4, 8, "fp32")]
COMPACT_TIES = [("ties 2:8 u4", 64, 512, 2, 8, 4, "bf16"),
                ("ties 1:4 u8", 33, 64, 1, 4, 8, "fp32"),
                ("ties 3:8 u4", 17, 96, 3, 8, 4, "fp32")]
# phase 15 nm_spmm_shared ragged cases: (label, B, K, F, n, m, tile,
# act dtype, vals dtype); tile None is one tile of TF = F (SharedOp)
SHARED_RAGGED = [
    ("B=1", 1, 4096, 4096, 2, 8, None, "bf16", "bf16"),
    ("B=3", 3, 4096, 1024, 2, 8, None, "bf16", "bf16"),
    ("B=37 F=384", 37, 1024, 384, 2, 8, None, "bf16", "bf16"),
    ("odd Kc 1:8", 5, 56, 20, 1, 8, None, "bf16", "bf16"),
    ("TF=1000", 4, 512, 1000, 2, 8, None, "bf16", "bf16"),
    ("2:4 F=130", 2, 256, 130, 2, 4, None, "bf16", "bf16"),
    ("4:16", 6, 512, 64, 4, 16, None, "bf16", "bf16"),
    ("tile 10 (nf=13, TF=10)", 3, 64, 130, 2, 8, 10, "bf16", "bf16"),
    ("fp32 act, fp32 vals", 4, 1024, 512, 2, 8, None, "fp32", "fp32"),
    ("bf16 act, fp32 vals", 4, 1024, 512, 2, 8, 128, "bf16", "fp32"),
    ("fp32 act, bf16 vals", 9, 1024, 256, 2, 8, None, "fp32", "bf16")]
PREFILL_ROWS = (4, 32)          # phase 17's prompts x prompt bucket


# phase 15 nm_compact cases on the element pack's strided layout beyond
# the seven weights: (label, K, F, n, m, idx_bits, dtype, kind, view);
# kind "ties" draws small integers with -0 for every zero, "nan" adds
# infinities and NaNs of random payload and sign (many groups hold two);
# view "off" reads the (F, K) view one element into the weight's storage
COMPACT_STRIDED = [
    ("F=1000", 512, 1000, 2, 8, 4, "bf16", "normal", None),
    ("view off one element", 512, 512, 2, 8, 4, "bf16", "normal", "off"),
    ("1:8 u4, odd G", 8 * 61, 1024, 1, 8, 4, "bf16", "ties", None),
    ("3:8 u4", 8 * 33, 512, 3, 8, 4, "bf16", "ties", None),
    ("NaN, -0 ties 2:8 u4", 512, 4096, 2, 8, 4, "bf16", "nan", None),
    ("NaN 3:8 u4 fp32", 8 * 33, 512, 3, 8, 4, "fp32", "nan", None),
    ("4:16 u8 fp32", 512, 1024, 4, 16, 8, "fp32", "ties", None),
    ("2:4 u4", 256, 2048, 2, 4, 4, "bf16", "normal", None)]
INT_VIEW = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def compact_view(x, n, m, idx_bits, variant="auto"):
    """nm_compact of the (F, K) view ``x`` of a (K, F) weight along K, as
    pack_tree_element runs it: vals and idx written as (Kc, F) planes
    through their transposed views."""
    from repro_torch.kernels import nm_compact as K

    f, k = x.shape
    kc = k // m * n
    vals = torch.empty((kc, f), dtype=x.dtype, device=x.device)
    idx = torch.empty(((kc + 1) // 2 if idx_bits == 4 else kc, f),
                      dtype=torch.uint8, device=x.device)
    K.nm_compact(x, n, m, idx_bits, out=(vals.t(), idx.t()), variant=variant)
    return vals, idx


def compact_bound_ms(r, k, n, m, idx_bits, itemsize):
    """Bytes over 3.35 TB/s: x read once, vals and the idx plane written."""
    kc = k // m * n
    kci = (kc + 1) // 2 if idx_bits == 4 else kc
    return r * (k * itemsize + kc * itemsize + kci) / HBM_BYTES_PER_S * 1e3


def compact_case_weight(gen, k, f, kind, dtype, dev):
    """A (K, F) weight for COMPACT_STRIDED."""
    if kind == "normal":
        return torch.randn((k, f), generator=gen, device=dev).to(dtype)
    w = torch.randint(-2, 3, (k, f), generator=gen, device=dev).to(dtype)
    w = torch.where(w == 0, torch.full_like(w, -0.0), w)
    if kind == "nan":
        at = torch.rand((k, f), generator=gen, device=dev)
        w = torch.where(at < 0.05, torch.full_like(w, math.inf), w)
        w = torch.where(at > 0.95, torch.full_like(w, -math.inf), w)
        bits = w.view(INT_VIEW[dtype])
        top = 8 * w.element_size()
        pay = torch.randint(1, 64, (k, f), generator=gen, device=dev)
        neg = torch.rand((k, f), generator=gen, device=dev) < 0.5
        nan = (pay | (0x7f80 << (top - 16))) | (neg.long() << (top - 1))
        pick = (at > 0.3) & (at < 0.45)
        bits[pick] = nan[pick].to(bits.dtype)
    return w


def expected_compact(x, n, m, idx_bits):
    """The plain version's (vals, idx) of (R, K) ``x``, a NaN survivor's
    bits x's own at its offset: the values are copied, and a gather of a
    NaN need not keep its payload."""
    from repro_torch.kernels import ref

    vals, idx = ref.ref_nm_compact(x, n, m, idx_bits)
    nan = torch.isnan(vals)
    if not bool(nan.any()):
        return vals, idx
    _, offs = ref.ref_nm_compact(x, n, m, 8)
    r, k = x.shape
    iv = INT_VIEW[x.dtype]
    raw = x.contiguous().view(iv).reshape(r, k // m, m)
    copied = torch.gather(raw, -1, offs.reshape(r, k // m, n).long())
    return torch.where(nan, copied.reshape(r, -1), vals.view(iv)).view(
        x.dtype), idx


def check_compact_view(x, n, m, bits, variants, label):
    """nm_compact of the (F, K) view ``x`` in each of ``variants`` against
    the plain version, bitwise; returns the variant each launch took."""
    from repro_torch.kernels import nm_compact as K

    want = expected_compact(x, n, m, bits)
    took = []
    for variant in variants:
        before = dict(K.variant_launches)
        vals, idx = compact_view(x, n, m, bits, variant)
        torch.cuda.synchronize()
        took += [v for v in K.VARIANTS if K.variant_launches[v] != before[v]]
        check(variant == "auto" or took[-1] == variant,
              f"nm_compact {label}: asked for {variant}, took {took[-1]}")
        check(bits_equal(vals.t(), want[0]) and bits_equal(idx.t(), want[1]),
              f"nm_compact {label} ({variant}): not bitwise equal")
    return took


def phase_compact(dev, gen):
    """nm_compact vs plain, bitwise, in both variants: the seven weights as
    the element pack reads them (u4 and u8), strided cases the vector
    variant must refuse or take, score rows, ragged shapes and ties; then
    each variant's device times per layer (cold L2)."""
    from repro_torch.kernels import nm_compact as K
    from repro_torch.kernels import ref

    for name, k, f in PROJ:
        w = torch.randn((k, f), generator=gen, device=dev).to(torch.bfloat16)
        for bits in (4, 8):
            check_compact_view(w.t(), 2, 8, bits, ("vector", "scalar"),
                               f"{name} u{bits}")
        print(f"  {name:7s} ({k}, {f}) bf16 along K, strided: vals and idx "
              "bitwise equal, u4 and u8, vector and scalar")
    for label, k, f, n, m, bits, dt, kind, view in COMPACT_STRIDED:
        w = compact_case_weight(gen, k, f + (view == "off"), kind,
                                DTYPES[dt], dev)
        x = (w.flatten()[1:1 + k * f].view(k, f) if view else w).t()
        # compact_view's planes: new (Kc, F) tensors, read transposed
        if K.vector_ok(f, x.element_size(), n,
                       (x.data_ptr(), x.stride(0), x.stride(1)), (0, 1, f),
                       (0, 1, f)):
            took = check_compact_view(x, n, m, bits, ("vector", "scalar"),
                                      label)
        else:
            took = check_compact_view(x, n, m, bits, ("auto", "scalar"),
                                      label)
            check(took[0] == "scalar", f"nm_compact {label}: auto took "
                  f"{took[0]}, not the scalar variant")
            count = K.launches
            try:
                compact_view(x, n, m, bits, "vector")
            except ValueError:
                pass
            else:
                raise RuntimeError(f"nm_compact {label}: the vector variant "
                                   "took a view it must refuse")
            check(K.launches == count, f"nm_compact {label}: a refused "
                  "launch counted")
        print(f"  {label:24s} ({k}, {f}) {dt} u{bits} strided: bitwise "
              f"equal, variants {took}"
              + ("" if "vector" in took else ", vector refused"))
    cases = [(f"score rows ({r}, {k})", r, k, 2, 8, 8, "fp32", False)
             for r, k in ((1, 4096), (1, 12288), (32, 4096), (96, 4096),
                          (32, 12288))]
    cases += [(*c, False) for c in COMPACT_RAGGED]
    cases += [(*c, True) for c in COMPACT_TIES]
    for label, r, k, n, m, bits, dt, ties in cases:
        if ties:
            x = torch.randint(-2, 3, (r, k), generator=gen, device=dev).to(
                DTYPES[dt])
            x = torch.where(x == 0, torch.full_like(x, -0.0), x)
        else:
            x = torch.randn((r, k), generator=gen, device=dev).to(
                DTYPES[dt])
            if label.startswith("score"):
                x = x.abs() * 64.0
        scalar = K.variant_launches["scalar"]
        got = K.nm_compact(x, n, m, bits)
        want = ref.ref_nm_compact(x, n, m, bits)
        torch.cuda.synchronize()
        check(bits_equal(got[0], want[0]) and bits_equal(got[1], want[1]),
              f"nm_compact {label}: not bitwise equal")
        check(K.variant_launches["scalar"] == scalar + 1,
              f"nm_compact {label}: auto did not take the scalar variant")
        print(f"  {label:24s} {dt} u{bits}: vals and idx bitwise equal "
              "(scalar)")
    rows = []
    for name, k, f in PROJ:
        copies = max(2, -(-2 * L2_BYTES // (k * f * 2)))
        ws = [torch.randn((k, f), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(copies)]
        # the median of three graph replays of each, in turns
        runs = {}
        for kind, bits in (("vector", 4), ("scalar", 4), ("vector", 8),
                           ("vector", 8), ("scalar", 4), ("vector", 4),
                           ("vector", 4), ("vector", 8), ("scalar", 4)):
            runs.setdefault(f"{kind} u{bits}", []).append(time_ms(
                lambda i: compact_view(ws[i].t(), 2, 8, bits, kind), copies))
        t = {key: sorted(v)[1] for key, v in runs.items()}
        t_p = time_ms(lambda i: ref.ref_nm_compact(ws[i].t(), 2, 8, 4),
                      copies, iters=5)
        t_b = compact_bound_ms(f, k, 2, 8, 4, 2)
        t_b8 = compact_bound_ms(f, k, 2, 8, 8, 2)
        rows.append({"proj": name, "K": k, "F": f, "ms": t["vector u4"],
                     "scalar_ms": t["scalar u4"], "u8_ms": t["vector u8"],
                     "u8_bound_ms": t_b8, "plain_ms": t_p, "bound_ms": t_b,
                     "bound_by": "bytes", "library_ms": None, "runs": runs})
        print(f"  pack {name:7s} {k:5d}x{f:<5d} bf16 u4: vector="
              f"{t['vector u4']:.4f} ms scalar={t['scalar u4']:.4f} ms "
              f"bound={t_b:.4f} ms (bytes) plain={t_p:.4f} ms "
              f"bound/vector={t_b / t['vector u4']:.2f}; u8 vector="
              f"{t['vector u8']:.4f} ms bound={t_b8:.4f} ms")
        del ws
    tot = {key: sum(r[key] for r in rows)
           for key in ("ms", "scalar_ms", "u8_ms", "bound_ms", "u8_bound_ms",
                       "plain_ms")}
    print(f"  one layer's element pack (7 weights, 2:8): u4 vector "
          f"{1e3 * tot['ms']:.1f} us = {tot['bound_ms'] / tot['ms']:.2f} of "
          f"its {1e3 * tot['bound_ms']:.1f} us bound, scalar "
          f"{1e3 * tot['scalar_ms']:.1f} us; u8 vector "
          f"{1e3 * tot['u8_ms']:.1f} us = "
          f"{tot['u8_bound_ms'] / tot['u8_ms']:.2f} of its "
          f"{1e3 * tot['u8_bound_ms']:.1f} us bound; plain "
          f"{1e3 * tot['plain_ms']:.1f} us")
    for k in (4096, 12288):
        xs = [torch.rand((1, k), generator=gen, device=dev) for _ in range(2)]
        t_k = time_ms(lambda i: K.nm_compact(xs[i], 2, 8), 2)
        t_p = time_ms(lambda i: ref.ref_nm_compact(xs[i], 2, 8), 2, iters=5)
        print(f"  score row (1, {k}) fp32 u8: kernel={1e3 * t_k:.2f} us "
              f"bound={1e3 * compact_bound_ms(1, k, 2, 8, 8, 4):.3f} us "
              f"plain={1e3 * t_p:.1f} us")
    return 0.0, rows


def shared_case(gen, b, k, f, n, m, tile, act_dt, vals_dt, dev):
    """(act, vals (nf, Kc, TF), rows (nf, Kc)) from a random weight packed
    as serving packs it (``shared_ff_pack``, one tile) or as
    ``ops.pack_shared`` does (tiles of ``tile`` columns)."""
    from repro_torch.core import bdwp
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import ops

    w = torch.randn((k, f), generator=gen, device=dev).to(DTYPES[vals_dt])
    if tile is None:
        vals, rows = bdwp.shared_ff_pack(w, SparsityConfig(n=n, m=m))
        vals, rows = vals[None], rows[None]
    else:
        vals, rows = ops.pack_shared(w, n, m, tile=tile)
    act = torch.randn((b, k), generator=gen, device=dev).to(DTYPES[act_dt])
    return act, vals.contiguous(), rows.contiguous()


def shared_bound_ms(b, k, kc, f, nf=1):
    moved = b * k * 2 + kc * f * 2 + nf * kc * 4 + b * f * 4
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, 2 * b * kc * f / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_shared(dev, gen):
    """nm_spmm_shared vs plain within the phase-3 tolerance, rows bitwise
    independent of the batch; then device times per layer (cold L2) at
    decode (B = 4) and prefill rows (4 x 32), against the bound, the
    plain version and torch.matmul on the dense bf16 weight."""
    from repro_torch.kernels import nm_spmm_shared as K
    from repro_torch.kernels import ref

    b_pre = PREFILL_ROWS[0] * PREFILL_ROWS[1]
    cases = [(f"{name} B={b} TF=F", b, k, f, 2, 8, None, "bf16", "bf16")
             for name, k, f in PROJ for b in (4, b_pre)]
    cases += [(f"{name} B=4 TF=128 (pack_shared)", 4, k, f, 2, 8, 128,
               "bf16", "bf16") for name, k, f in PROJ]
    cases += [(f"ragged {c[0]}", *c[1:]) for c in SHARED_RAGGED]
    worst = 0.0
    for label, b, k, f, n, m, tile, adt, vdt in cases:
        act, vals, rows = shared_case(gen, b, k, f, n, m, tile, adt, vdt, dev)
        out = K.nm_spmm_shared(act, vals, rows)
        again = K.nm_spmm_shared(act, vals, rows)
        row0 = K.nm_spmm_shared(act[:1].contiguous(), vals, rows)
        plain = ref.ref_nm_spmm_shared(act, vals, rows)
        scale = ref.ref_nm_spmm_shared(act.abs(), vals.abs(), rows)
        torch.cuda.synchronize()
        err = (out - plain).abs()
        excess = float((err - TOL * scale).max())
        abs_err = float(err.max())
        worst = max(worst, abs_err)
        print(f"  {label:34s} max_abs_err={abs_err:.3e} "
              f"max_rel_err={float((err / scale.clamp_min(1e-30)).max()):.3e}"
              f" (tol {TOL:g} x |act|@|W|)")
        check(excess <= 0, f"nm_spmm_shared {label}: error above tolerance")
        check(torch.equal(out, again),
              f"nm_spmm_shared {label}: not deterministic")
        check(torch.equal(out[:1], row0),
              f"nm_spmm_shared {label}: row 0 depends on the batch")
    rows_t = []
    for b in (4, b_pre):
        for name, k, f in PROJ:
            kc = k // 4
            copies = max(2, -(-2 * L2_BYTES // (kc * f * 2)))
            sets = [shared_case(gen, b, k, f, 2, 8, None, "bf16", "bf16", dev)
                    for _ in range(copies)]
            act = sets[0][0]
            dense = [torch.randn((k, f), generator=gen, device=dev).to(
                torch.bfloat16) for _ in range(max(2, -(-2 * L2_BYTES
                                                         // (k * f * 2))))]
            t_k = time_ms(lambda i: K.nm_spmm_shared(act, *sets[i][1:]),
                          copies)
            t_p = time_ms(lambda i: ref.ref_nm_spmm_shared(act, *sets[i][1:]),
                          copies, iters=10)
            t_l = time_ms(lambda i: torch.matmul(act, dense[i]), len(dense))
            t_b, by = shared_bound_ms(b, k, kc, f)
            pl = K.plan(b, kc, f, 1)
            rows_t.append({"proj": name, "B": b, "K": k, "F": f, "ms": t_k,
                           "plain_ms": t_p, "library_ms": t_l,
                           "bound_ms": t_b, "bound_by": by,
                           "config": pl.config, "splits": pl.splits,
                           "scratch_bytes": pl.scratch_floats * 4
                           + b * -(-kc // 8) * 8 * 2})
            print(f"  B={b:3d} {name:7s} {k:5d}x{f:<5d} kernel={t_k:.4f} ms "
                  f"bound={t_b:.4f} ms ({by}) plain={t_p:.4f} ms "
                  f"torch.matmul(dense bf16)={t_l:.4f} ms; config "
                  f"{pl.config}, split {pl.splits}")
            del sets, dense
        rs = [r for r in rows_t if r["B"] == b]
        t = {key: sum(r[key] for r in rs)
             for key in ("ms", "library_ms", "bound_ms", "scratch_bytes")}
        print(f"  B={b} one layer (7 projections): {1e3 * t['ms']:.2f} us = "
              f"{t['ms'] / t['library_ms']:.2f}x dense torch.matmul "
              f"({1e3 * t['library_ms']:.2f} us), "
              f"{t['ms'] / t['bound_ms']:.2f}x the bound "
              f"({1e3 * t['bound_ms']:.2f} us); scratch (partials and the "
              f"gathered activations) {t['scratch_bytes']} bytes")
    return worst, rows_t


SHARED_STEPS = 16               # phase 17's greedy decode steps


def _trees_bitwise(a, b) -> bool:
    """Two param trees (SharedOp or tensor leaves) equal bit for bit."""
    from repro_torch.core.operand import SharedOp

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_bitwise(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_trees_bitwise, a, b))
    if isinstance(a, SharedOp):
        return (isinstance(b, SharedOp) and _trees_bitwise(a.vals, b.vals)
                and _trees_bitwise(a.idx, b.idx))
    return bits_equal(a.cpu(), b.cpu())


def prefill_extended(params, toks, last, extra: int, cfg, sp):
    """Prefill right-padded prompts (B, S) with ``last_index``; returns the
    logits and a cache ``extra`` positions deeper holding the prefill's
    KV, for per-slot decode steps past S."""
    from repro_torch.models import transformer_lm as T
    from repro_torch.train import step as ST

    b, s = toks.shape
    logits, pre = ST.lm_prefill_step(params, {"tokens": toks}, cfg=cfg,
                                     sp_cfg=sp, last_index=last)
    cache = T.init_lm_cache(cfg, b, s + extra, device=toks.device)
    for dst, src in zip(cache["layers"], pre["layers"]):
        for key in ("k", "v"):
            dst[key][:, :s] = src[key]
    return logits, cache


def phase_shared_small(dev, seed):
    """SMOKE shared-pattern serving: pack_tree_shared on the card and on
    the CPU bitwise equal; prefill + 8 greedy decode steps, logits within
    SMALL_ATOL."""
    from repro_torch.configs import qwen3_8b as C
    from repro_torch.core import bdwp
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.models import transformer_lm as T
    from repro_torch.train import step as ST

    cfg = C.SMOKE
    sp = SparsityConfig(n=2, m=8, method="bdwp", granularity="shared")
    params = T.init(cfg, seed=seed, device="cpu", dtype=torch.bfloat16)
    on = {d: bdwp.pack_tree_shared(params, sp, device=d) for d in ("cpu", dev)}
    check(_trees_bitwise(on["cpu"], on[dev]),
          "small shared: pack_tree_shared trees differ between card and CPU")
    print("  pack_tree_shared: card and CPU trees bitwise equal")
    lens, steps = (5, 9), 8
    toks = np.zeros((2, 12), np.int64)
    rng = np.random.default_rng(seed)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab, n)
    logits, caches = {}, {}
    for d, p in on.items():
        logits[d], caches[d] = prefill_extended(
            p, torch.from_numpy(toks).to(d), [n - 1 for n in lens], steps,
            cfg, sp)
    pos, worst = torch.tensor(lens), 0.0
    for step in range(steps + 1):
        a, b = logits["cpu"], logits[dev].cpu()
        check(bool(torch.isfinite(b[..., :cfg.vocab]).all()),
              "small shared: non-finite logits on the card")
        worst = max(worst, float((a - b).abs().max()))
        if step == steps:
            break
        tok = torch.argmax(a[:, -1, :cfg.vocab], -1)[:, None]
        for d, p in on.items():
            logits[d], caches[d] = ST.lm_decode_step(
                p, caches[d], tok.to(d), (pos + step).to(d), cfg=cfg,
                sp_cfg=sp)
    print(f"  SMOKE prefill + {steps} decode steps, card vs CPU: "
          f"max |dlogit| = {worst:.3e} (tol {SMALL_ATOL})")
    check(worst <= SMALL_ATOL, "small shared: card and CPU logits disagree")
    return worst


def phase_shared_serve(dev, seed, cfg=None):
    """qwen3-8b FULL (or ``cfg``), 2:8 shared-pattern serving:
    pack_tree_shared layer by
    layer on the card, 4 right-padded prompts prefilled, then greedy
    per-slot decode steps; exact launch counts, layer 0 against the plain
    pack, tokens independent of the batch's row order."""
    from repro_torch.configs import qwen3_8b as C
    from repro_torch.core import bdwp
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import nm_compact as KC
    from repro_torch.kernels import nm_spmm_shared as KS
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer_lm as T
    from repro_torch.train import step as ST

    cfg = cfg or C.FULL
    sp = SparsityConfig(n=2, m=8, method="bdwp", granularity="shared")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = T.generator(seed, dev)
    t0 = time.perf_counter()
    shell = T.init_shell(cfg, gen, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    shell_s, draws = time.perf_counter() - t0, [0.0]
    KC.launches = 0
    KC.variant_launches.update(dict.fromkeys(KC.VARIANTS, 0))
    t0 = time.perf_counter()
    params = bdwp.pack_tree_shared(shell, sp, device=dev)
    params["blocks"], layer0 = [], None
    for block in timed_draws(T.iter_blocks(cfg, gen, device=dev,
                                           dtype=torch.bfloat16), draws):
        layer0 = block if layer0 is None else layer0
        params["blocks"].append(bdwp.pack_tree_shared(
            {"blocks": block}, sp, device=dev)["blocks"])
        del block
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0 - draws[0]
    compact, compact_variants = KC.launches, dict(KC.variant_launches)
    del shell
    print(f"  init {shell_s + draws[0]:.1f} s + pack_tree_shared {pack_s:.4f}"
          f" s ({cfg.n_layers} layers, nm_compact launches {compact}, want "
          f"{7 * cfg.n_layers}, by variant {compact_variants})")
    check(compact == 7 * cfg.n_layers, "shared serve: nm_compact launches")
    # the pattern's (1, K) score rows are contiguous: the scalar variant
    check(compact_variants["scalar"] == compact,
          "shared serve: a score-row launch took the vector variant")
    for part, name in PROJ_PATHS:
        w, op = layer0[part][name]["w"], params["blocks"][0][part][name]["w"]
        _, offsets = ref.ref_nm_compact(w.abs().float().sum(1)[None], 2, 8)
        rows = ops.group_rows(offsets[0], 2, 8)
        check(bits_equal(op.idx, rows)
              and bits_equal(op.vals, w.index_select(0, rows)),
              f"shared serve: layer 0 {name} SharedOp != the plain pack")
    print("  layer 0: every SharedOp bitwise equal to the plain pack")
    del layer0

    rng = np.random.default_rng(seed + 17)
    lens = (5, 32, 17, 9)
    prompts = [rng.integers(0, cfg.vocab, n) for n in lens]
    bucket = PREFILL_ROWS[1]

    def greedy(order):
        toks = np.zeros((len(order), bucket), np.int64)
        for i, j in enumerate(order):
            toks[i, :lens[j]] = prompts[j]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_extended(
            params, torch.from_numpy(toks).to(dev),
            [lens[j] - 1 for j in order], SHARED_STEPS, cfg, sp)
        tok = torch.argmax(logits[:, -1, :cfg.vocab], -1)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        out, times = [tok], []
        pos = torch.tensor([lens[j] for j in order], device=dev)
        for step in range(SHARED_STEPS):
            t0 = time.perf_counter()
            logits, cache = ST.lm_decode_step(params, cache, tok[:, None],
                                              pos + step, cfg=cfg, sp_cfg=sp)
            tok = torch.argmax(logits[:, -1, :cfg.vocab], -1)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            out.append(tok)
        check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
              "shared serve: non-finite logits")
        check(tuple(logits.shape) == (len(order), 1, cfg.padded_vocab),
              "shared serve: logits shape")
        return torch.stack(out, 1).tolist(), prefill_ms, times

    KS.launches = 0
    tokens, prefill_ms, times = greedy((0, 1, 2, 3))
    launches = KS.launches
    want = 7 * cfg.n_layers * (1 + SHARED_STEPS)
    ms = sorted(times)[len(times) // 2]
    b = len(lens)
    print(f"  prefill {b} x {bucket} tokens {prefill_ms:.1f} ms; "
          f"{SHARED_STEPS} decode steps, median {ms:.2f} ms/step "
          f"({min(times):.2f}-{max(times):.2f}), {b / ms * 1e3:.1f} tok/s; "
          f"nm_spmm_shared launches {launches} (want {want})")
    check(launches == want, "shared serve: nm_spmm_shared launch count")
    order = (2, 0, 3, 1)
    permuted, prefill2, times2 = greedy(order)
    for i, j in enumerate(order):
        check(permuted[i] == tokens[j], f"shared serve: prompt {j}'s tokens "
              "change when the batch's rows are permuted")
    print(f"  rows permuted {order}: every prompt's {SHARED_STEPS + 1} greedy "
          f"tokens unchanged (prefill {prefill2:.1f} ms, median "
          f"{sorted(times2)[len(times2) // 2]:.2f} ms/step)")

    toks = np.zeros((b, bucket), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :lens[i]] = p
    logits, cache = prefill_extended(
        params, torch.from_numpy(toks).to(dev), [n - 1 for n in lens],
        SHARED_STEPS, cfg, sp)
    state = {"tok": torch.argmax(logits[:, -1, :cfg.vocab], -1),
             "cache": cache, "pos": torch.tensor(lens, device=dev)}
    del logits, cache

    def decode_one():
        logits, state["cache"] = ST.lm_decode_step(
            params, state["cache"], state["tok"][:, None], state["pos"],
            cfg=cfg, sp_cfg=sp)
        state["tok"] = torch.argmax(logits[:, -1, :cfg.vocab], -1)
        state["pos"] = state["pos"] + 1

    prof = profile_steps(decode_one, 5, ("nm_spmm_shared",))
    peak = torch.cuda.max_memory_allocated()
    print(f"  max_memory_allocated {peak / 2**30:.2f} GiB")
    del params, state
    return {"launches": launches, "compact_launches": compact,
            "compact_variants": compact_variants,
            "pack_s": pack_s, "prefill_ms": prefill_ms,
            "decode_ms_per_step": ms, "decode_ms": times,
            "tok_per_s": b / ms * 1e3, "permuted_prefill_ms": prefill2,
            "permuted_decode_ms": times2, "max_memory_allocated": peak,
            "profile": prof}


# phases 18-20: the paper's image models (Table I), 2:8 bdwp, packed
# pre-generation, at the batch of PAPER_MODELS
PAPER_NAMES = ("resnet9", "vgg19", "vit")
PAPER_STEPS = 5
# exact launches per training step: (fused_update launches, the sites
# they cover, nm_spmm launches): one grouped fused_update over every
# pre-generated site, one nm_spmm per ViT linear's forward (6 per block,
# no recompute)
PAPER_LAUNCHES = {"resnet9": (1, 7, 0), "vgg19": (1, 15, 0),
                  "vit": (1, 42, 42)}
PAPER_BATCH = None              # None: each model's Table I batch
PAPER_WIDTH = 64                # ResNet9's base width in Table I
# card vs CPU at small size: ResNet9 (width 16) and a 2-block ViT,
# three steps at lr 0.02 on 32 images (at lr 0.1 on 8 images ResNet9's
# loss jumps from 4.7 to 22 by step 2, which amplifies any difference);
# the losses
# differ by the bf16 roundings of cuDNN's and cuBLAS's fp32 sums,
# carried through the updates from step 2 on
PAPER_SMALL_LOSS_ATOL = (2e-2, 2e-2, 5e-2)
PAPER_SMALL_ROWS = 32
# ResNet18 on the MaskedOp path, card vs CPU: logits within 2e-2 of
# their largest magnitude, each gradient within 5e-2 of its leaf's
# largest (the CPU tests hold the CPU path to the reference at 2e-2);
# ResNet50's convs one by one within 2^-7 of their largest output or
# gradient (one bf16 ulp of an fp32 sum rounded in another order)
PAPER_LOGIT_RTOL, PAPER_GRAD_RTOL = 2e-2, 5e-2


def _site_views(master, sp):
    """(name, (H*W*I or K, O) view) of every pre-generated site of a
    master tree, in tree order."""
    return [(name, (w.numel() // w.shape[-1], w.shape[-1]))
            for name, w in _site_leaves(master, sp)]


def _site_leaves(master, sp):
    """(name, tensor) of every pre-generated site of a master tree, in
    tree order (per layer)."""
    from repro_torch.core import bdwp
    from repro_torch.optim import sgd

    out = []
    sgd.tree_map(lambda name, w: out.append((name, w))
                 if bdwp.pregen_site(name, tuple(w.shape), sp) else None,
                 master)
    return out


def phase_paper_kernels(dev, gen):
    """nm_spmm at ViT's rows and fused_update at the site views of
    ResNet9, VGG19 and ViT: against their plain versions, then device
    times (CUDA graph replay, cold L2) beside their bounds."""
    from repro_torch.configs import paper_models as PM
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import fused_update as KF
    from repro_torch.kernels import nm_spmm as KS
    from repro_torch.kernels import ref
    from repro_torch.models import convnets as CN

    sp = SparsityConfig(n=2, m=8, method="bdwp")
    vit = PM.VIT_PAPER
    # rows of every ViT linear: each image's patches and its class token
    b = (PAPER_BATCH or PM.PAPER_MODELS["vit"].batch) * (
        (vit.image // vit.patch) ** 2 + 1)
    d, ff = vit.d_model, vit.d_ff
    shapes = [("q_proj", d, d), ("k_proj", d, d), ("v_proj", d, d),
              ("o_proj", d, d), ("w_in", d, ff), ("w_out", ff, d)]
    worst_spmm, spmm_rows = 0.0, []
    for name, k, f in shapes:
        act, vals, idx, w, e = spmm_case_err(gen, b, name, k, f, dev)
        one = KS.nm_spmm(act[:1].contiguous(), vals, idx, 2, 8, 8)
        full = KS.nm_spmm(act, vals, idx, 2, 8, 8)
        torch.cuda.synchronize()
        check(bits_equal(full[:1], one),
              f"nm_spmm ViT rows {name}: row 0 differs from B = 1")
        worst_spmm = max(worst_spmm, e)
        t_k = time_ms(lambda i: KS.nm_spmm(act, vals, idx, 2, 8, 8), 1,
                      iters=10)
        t_l = time_ms(lambda i: torch.matmul(act, w), 1, iters=10)
        t_p = time_ms(lambda i: ref.ref_nm_spmm(act, vals, idx, 2, 8, 8), 1,
                      iters=3)
        t_b, by = spmm_train_bound_ms(b, k, f, vals.shape[0])
        spmm_rows.append({"proj": name, "B": b, "K": k, "F": f, "ms": t_k,
                          "plain_ms": t_p, "library_ms": t_l,
                          "bound_ms": t_b, "bound_by": by,
                          "dense_work_ms": dense_work_ms(b, k, f),
                          "max_abs_err": e})
        print(f"  nm_spmm B={b} {name:7s} {k:5d}x{f:<5d} kernel={t_k:.4f} ms "
              f"torch.matmul(dense bf16)={t_l:.4f} ms bound={t_b:.4f} ms "
              f"({by}) plain={t_p:.3f} ms; row 0 == B=1 bitwise")
        del act, vals, idx, w
    t = {key: sum(r[key] for r in spmm_rows)
         for key in ("ms", "library_ms", "bound_ms", "plain_ms")}
    print(f"  nm_spmm one ViT block's forward (6 linears, B={b}): kernel "
          f"{t['ms']:.4f} ms = {t['ms'] / t['library_ms']:.2f}x dense "
          f"torch.matmul ({t['library_ms']:.4f} ms), "
          f"{t['ms'] / t['bound_ms']:.2f}x its bound ({t['bound_ms']:.4f} "
          f"ms); max abs err {worst_spmm:.3e} (tol {TOL:g} x |act|@|W|)")

    s = UPDATE_SCALARS
    args = (s["lr"], s["mu"], s["wd"], s["lam"], 2, 8)
    worst_upd, upd_rows = 0.0, {}   # fused_update is held bitwise
    for model_name in PAPER_NAMES:
        model = PM.image_model(model_name, PAPER_WIDTH)
        views = [v for _, v in _site_views(CN.init(model, seed=0,
                                                   device=dev), sp)]
        worst_upd = max(worst_upd, grouped_update_check(
            gen, views, dev, s, f"{model_name}'s {len(views)} sites"))
        rows = []
        for (k, f), count in sorted(collections.Counter(views).items()):
            copies = max(2, -(-2 * L2_BYTES // (k * f * 10)))
            sets = [update_case(gen, k, f, dev) for _ in range(copies)]
            t_k = time_ms(lambda i: KF.fused_update(*sets[i], *args,
                                                    bp_mode="bdwp"),
                          copies, iters=max(20, copies))
            t_p = time_ms(lambda i: ref.ref_fused_update(
                *sets[i], n=2, m=8, axis=0, bp_mode="bdwp", **s), copies,
                iters=min(copies, 10))
            t_b = update_bound_ms(k, f, 2, 8)
            rows.append({"view": [k, f], "sites": count, "ms": t_k,
                         "plain_ms": t_p, "bound_ms": t_b,
                         "bound_by": "bytes", "library_ms": None})
            print(f"  fused_update {model_name:7s} ({k:5d}, {f:4d}) x{count:2d} "
                  f"one site kernel={t_k:.4f} ms bound={t_b:.4f} ms (bytes) "
                  f"plain={t_p:.4f} ms bound/kernel={t_b / t_k:.2f}")
            del sets
        tot = {key: sum(r[key] * r["sites"] for r in rows)
               for key in ("ms", "plain_ms", "bound_ms")}
        step_bytes = sum(k * f * 10 for k, f in views)
        copies = max(2, -(-2 * L2_BYTES // step_bytes))
        sets = [[update_case(gen, k, f, dev) for k, f in views]
                for _ in range(copies)]
        t_g = time_ms(lambda i: KF.fused_update_sites(sets[i], *args,
                                                      "bdwp"),
                      copies, iters=max(20, copies))
        del sets
        print(f"  fused_update {model_name}: one step's {len(views)} sites "
              f"in one grouped launch {t_g:.4f} ms against a "
              f"{tot['bound_ms']:.4f} ms bound (bound/kernel "
              f"{tot['bound_ms'] / t_g:.2f}); {len(views)} single launches "
              f"{tot['ms']:.4f} ms; plain {tot['plain_ms']:.3f} ms; "
              f"bitwise equal to per-site plain calls")
        upd_rows[model_name] = {"views": rows, "sites": len(views),
                                "singles_ms": tot["ms"], "ms": t_g,
                                "plain_ms": tot["plain_ms"],
                                "bound_ms": tot["bound_ms"]}
    return worst_spmm, spmm_rows, worst_upd, upd_rows


def _grads_close(a, b, rtol):
    """Largest |a - b| of each leaf pair within rtol of b's largest."""
    from repro_torch.optim import sgd

    worst = 0.0
    for x, y in zip(sgd.tree_leaves(a), sgd.tree_leaves(b)):
        x, y = x.float().cpu(), y.float()
        scale = float(y.abs().max())
        if scale:
            worst = max(worst, float((x - y).abs().max()) / scale)
    return worst <= rtol, worst


def _resnet18_card_vs_cpu(dev, seed, sp, label, whole_grads=True):
    """ResNet18 (width 8) on the MaskedOp path, from the fp32 master at
    init on 4 images of 32 px: logits and the gradients of every float
    leaf on the card against the CPU (without ``whole_grads`` the
    gradients are printed and the caller holds them conv by conv,
    ``_sdgp_layer_by_layer``)."""
    from repro_torch.data import synthetic as D
    from repro_torch.models import convnets as CN
    from repro_torch.optim import sgd

    model = CN.ImageModel("resnet18", 16, 8)
    master = sgd.init_state(CN.init(model, seed=seed, device="cpu"))["master"]
    images, labels = D.image_batch(D.ImageTaskConfig(
        image=32, num_classes=16, batch=4, seed=seed), 0, device="cpu")
    out = {}
    for d in ("cpu", dev):
        tree = sgd.tree_map(lambda _, t: t.to(d, copy=True), master)
        leaves = [t.requires_grad_(True) for t in sgd.tree_leaves(tree)
                  if t.is_floating_point()]
        logits = CN.apply(model, tree, images.to(d, torch.bfloat16), sp)
        grads = torch.autograd.grad(CN.image_loss(logits, labels.to(d)),
                                    leaves, allow_unused=True,
                                    materialize_grads=True)
        out[d] = (logits.detach(), list(grads))
    ok_l, err_l = _grads_close([out[dev][0]], [out["cpu"][0]],
                               PAPER_LOGIT_RTOL)
    ok_g, err_g = _grads_close(out[dev][1], out["cpu"][1], PAPER_GRAD_RTOL)
    print(f"  {label}: logits {err_l:.3e} of their largest (tol "
          f"{PAPER_LOGIT_RTOL}), gradients worst leaf {err_g:.3e} ("
          + (f"tol {PAPER_GRAD_RTOL}" if whole_grads
             else "held conv by conv from the CPU's incoming gradients")
          + "), card vs CPU")
    check(ok_l and (ok_g or not whole_grads),
          f"small {label}: card and CPU disagree")
    return master


SDGP_PROBE = "s2b1/c1"           # the conv where card and CPU part


def _conv_backward_calls(model, tree, images, labels, sp):
    """Every conv of one forward and backward of ``model`` on ``tree``:
    {name, w, x, stride, g}, ``g`` the conv's incoming output gradient
    (bf16, NHWC) in the backward of the mean cross-entropy."""
    from repro_torch.models import convnets as CN

    calls, conv = [], CN._nm_conv_auto

    def spy(leaf, x, sp_cfg, name, stride=1, padding="SAME"):
        y = conv(leaf, x, sp_cfg, name, stride, padding)
        rec = {"name": name, "w": leaf["w"].detach(), "x": x.detach(),
               "stride": stride}
        y.register_hook(lambda g, rec=rec: rec.__setitem__("g", g.detach()))
        calls.append(rec)
        return y

    CN._nm_conv_auto = spy
    try:
        from repro_torch.optim import sgd

        leaves = [t.requires_grad_(True) for t in sgd.tree_leaves(tree)
                  if t.is_floating_point()]
        loss = CN.image_loss(CN.apply(model, tree, images, sp), labels)
        torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        CN._nm_conv_auto = conv
    return calls


def _tie_gaps(g, n, m, groups):
    """Of each listed m-group (along the last axis of the bf16 ``g``),
    the gap between its n-th and (n+1)-th largest |g|, in bf16 ulps."""
    a = g.abs().reshape(-1, m)[groups]
    bits = a.contiguous().view(torch.int16).to(torch.int32)
    top = torch.sort(bits, dim=-1, descending=True).values
    return (top[:, n - 1] - top[:, n]).tolist()


def _sdgp_layer_by_layer(dev, seed, sp, master, label):
    """SDGP's backward selects the output gradient's n largest of each m
    across output channels.  At ``SDGP_PROBE``: the card's own incoming
    gradient, selected on the CPU, must give the card's selection bit
    for bit; the groups where the card's and the CPU's own selections
    differ and the ulp gaps of their near-ties are printed.  Then every
    conv's backward on the card, fed the CPU's input, weight and
    incoming gradient, must select bitwise as the CPU does and give its
    dx and dw within 2^-7 of their largest."""
    from repro_torch.core import sparsity as S
    from repro_torch.data import synthetic as D
    from repro_torch.models import convnets as CN
    from repro_torch.optim import sgd

    model = CN.ImageModel("resnet18", 16, 8)
    images, labels = D.image_batch(D.ImageTaskConfig(
        image=32, num_classes=16, batch=4, seed=seed), 0, device="cpu")
    runs = {}
    for d in ("cpu", dev):
        tree = sgd.tree_map(lambda _, t: t.to(d, copy=True), master)
        runs[d] = {c["name"]: c for c in _conv_backward_calls(
            model, tree, images.to(d, torch.bfloat16), labels.to(d), sp)}
    n, m = sp.n, sp.m
    probe_c, probe_g = runs["cpu"][SDGP_PROBE], runs[dev][SDGP_PROBE]
    g_card = probe_g["g"]
    sel_card = S.nm_mask(g_card, n, m, axis=-1)
    same_sel = bits_equal(S.nm_mask(g_card.cpu(), n, m, axis=-1),
                          sel_card.cpu())
    own_cpu = S.nm_mask(probe_c["g"], n, m, axis=-1).reshape(-1, m)
    flips = (own_cpu != sel_card.cpu().reshape(-1, m)).any(-1)
    groups = flips.nonzero()[:, 0]
    gaps = _tie_gaps(probe_c["g"], n, m, groups)
    g_rel = float((g_card.float().cpu() - probe_c["g"].float()).abs().max()
                  / probe_c["g"].float().abs().max())
    print(f"  {label} at {SDGP_PROBE}: the card's incoming gradient "
          f"selected on the CPU == the card's selection bitwise: "
          f"{same_sel}; the card's and the CPU's own incoming gradients "
          f"differ by {g_rel:.3e} of the largest, their selections in "
          f"{len(gaps)} of {own_cpu.shape[0]} groups, those groups' "
          f"{n}nd-{n + 1}rd |g| gaps in ulps {sorted(gaps)[:12]}"
          + (" ..." if len(gaps) > 12 else ""))
    check(same_sel, f"{label}: the card selects otherwise than the CPU on "
          "the same gradient")
    # where the two backwards part: each conv's incoming gradient, in the
    # order the backward reaches them, and the first one whose own
    # selections differ, with its near-ties
    trail, first = [], None
    for name in reversed(list(runs["cpu"])):
        gc, gd = runs["cpu"][name]["g"], runs[dev][name]["g"].cpu()
        rel = float((gd.float() - gc.float()).abs().max()
                    / gc.float().abs().max())
        differ = (S.nm_mask(gc, n, m, axis=-1).reshape(-1, m)
                  != S.nm_mask(gd, n, m, axis=-1).reshape(-1, m)).any(-1)
        trail.append(f"{name} {rel:.1e}/{int(differ.sum())}")
        if first is None and bool(differ.any()):
            first = (name, int(differ.sum()), differ.numel(),
                     sorted(_tie_gaps(gc, n, m, differ.nonzero()[:, 0])))
    print("    incoming gradients card vs CPU in backward order (conv "
          "relative difference/groups selected otherwise): "
          + ", ".join(trail))
    if first is not None:
        print(f"    first conv whose selections differ: {first[0]}, "
              f"{first[1]} of {first[2]} groups, 2nd-3rd |g| gaps in ulps "
              f"{first[3][:12]}")
    worst, sel_ok = 0.0, 0
    for name, c in runs["cpu"].items():
        res = {}
        for d in ("cpu", dev):
            xd = c["x"].to(d).requires_grad_(True)
            wd = c["w"].to(d).requires_grad_(True)
            y = CN._nm_conv_auto({"w": wd}, xd, sp, name, c["stride"])
            res[d] = torch.autograd.grad(y, (xd, wd), c["g"].to(d))
        sel_ok += bits_equal(S.nm_mask(c["g"].to(dev), n, m, axis=-1).cpu(),
                             S.nm_mask(c["g"], n, m, axis=-1))
        for a, b in zip(res[dev], res["cpu"]):
            worst = max(worst, float((a.float().cpu() - b.float()).abs().max())
                        / float(b.float().abs().max()))
    print(f"    conv by conv from the CPU's input, weight and incoming "
          f"gradient: selections bitwise in {sel_ok} of {len(runs['cpu'])} "
          f"convs, dx/dw worst {worst:.3e} of the largest (tol "
          f"{2.0 ** -7:.3e})")
    check(sel_ok == len(runs["cpu"]) and worst <= 2.0 ** -7,
          f"{label}: a conv's SDGP backward differs between card and CPU "
          "given the same incoming gradient")
    return {"probe_groups": own_cpu.shape[0], "probe_flips": len(gaps),
            "probe_gaps_ulps": sorted(gaps), "probe_grad_rel": g_rel,
            "worst": worst, "trail": trail, "first": first}


def phase_paper_small(dev, seed):
    """ResNet9 (width 16) and a 2-block ViT: three steps on the card and
    on the CPU from the same params and batches; ResNet18/50 (width 8)
    on the MaskedOp path: logits and gradients, card vs CPU."""
    import functools

    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data import synthetic as D
    from repro_torch.models import convnets as CN
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST

    sp = SparsityConfig(n=2, m=8, method="bdwp")
    opt = sgd.SGDConfig(lr=0.02, warmup_steps=2, total_steps=50)
    for model in (CN.ImageModel("resnet9", 10, 16),
                  CN.ImageModel("vit", 10, vit=CN.ViTConfig(
                      image=32, patch=4, d_model=64, n_layers=2, n_heads=4,
                      d_ff=128, num_classes=10))):
        params = CN.init(model, seed=seed, device="cpu")
        states = {d: ST.train_state_from_params(
            sgd.tree_map(lambda _, t: t.to(d, copy=True), params), sp)
            for d in ("cpu", dev)}
        check(_compute_bitwise(states["cpu"]["compute"],
                               states[dev]["compute"]),
              f"small {model.name}: step-0 compute trees differ")
        icfg = D.ImageTaskConfig(image=32, num_classes=model.num_classes,
                                 batch=PAPER_SMALL_ROWS, seed=seed)
        step = functools.partial(ST.image_train_step, model=model,
                                 sp_cfg=sp, opt_cfg=opt)
        for i in range(3):
            loss = {}
            for d in states:
                images, labels = D.image_batch(icfg, i, device=d)
                states[d], met = step(states[d], {"images": images,
                                                  "labels": labels})
                loss[d] = float(met["loss"])
            diff = abs(loss["cpu"] - loss[dev])
            print(f"  {model.name} step {i}: loss card {loss[dev]:.6f} cpu "
                  f"{loss['cpu']:.6f} |d| {diff:.3e} (tol "
                  f"{PAPER_SMALL_LOSS_ATOL[i]})")
            check(math.isfinite(loss[dev]), f"small {model.name}: non-finite")
            check(diff <= PAPER_SMALL_LOSS_ATOL[i],
                  f"small {model.name}: step {i} losses disagree")
    _resnet18_card_vs_cpu(dev, seed, sp, "resnet18 (MaskedOp)")
    images, _ = D.image_batch(D.ImageTaskConfig(
        image=32, num_classes=16, batch=4, seed=seed), 0, device="cpu")
    # ResNet50's 53 convs one by one, on the inputs of its CPU forward:
    # the whole model at this width and batch is chaotic (50 batch
    # norms), card and CPU logits differ by about 2.5%
    model = CN.ImageModel("resnet50", 16, 8)
    master = sgd.init_state(CN.init(model, seed=seed, device="cpu"))["master"]
    calls = _conv_calls(model, master, images.to(torch.bfloat16), sp)
    gen = torch.Generator().manual_seed(seed)
    worst, kinds = _convs_card_vs_cpu(dev, calls, sp, gen)
    pool_in = torch.randn((4, 17, 16, 8), generator=gen).to(torch.bfloat16)
    pooled = {d: CN._max_pool(pool_in.to(d), 3, 2, "SAME") for d in
              ("cpu", dev)}
    print(f"  resnet50 (MaskedOp): {len(calls)} convs (kernel, stride) "
          f"{sorted(kinds)}, card vs CPU y/dx/dw worst {worst:.3e} of the "
          f"largest (tol {2.0 ** -7:.3e}); SAME 3x3/2 max-pool of a 17x16 "
          f"input bitwise: {bits_equal(pooled[dev].cpu(), pooled['cpu'])}")
    check(len(calls) == 53 and worst <= 2.0 ** -7,
          "small resnet50: a conv differs between card and CPU")
    check(bits_equal(pooled[dev].cpu(), pooled["cpu"]),
          "small: SAME max-pool differs between card and CPU")


def _convs_card_vs_cpu(dev, calls, sp, gen):
    """Each conv of ``calls`` alone on the card and on the CPU, its
    output cotangent drawn from ``gen``: the worst |y|, |dx| or |dw|
    difference over its largest, and the (kernel, stride) kinds seen."""
    from repro_torch.models import convnets as CN

    worst, kinds = 0.0, set()
    for name, w, x, stride in calls:
        g = None
        res = {}
        for d in ("cpu", dev):
            xd = x.to(d).requires_grad_(True)
            wd = w.to(d).requires_grad_(True)
            y = CN._nm_conv_auto({"w": wd}, xd, sp, name, stride)
            if g is None:
                g = torch.randn(y.shape, generator=gen).to(torch.bfloat16)
            res[d] = (y.detach(), *torch.autograd.grad(y, (xd, wd), g.to(d)))
        for a, b in zip(res[dev], res["cpu"]):
            err = float((a.float().cpu() - b.float()).abs().max()) / float(
                b.float().abs().max())
            worst = max(worst, err)
        kinds.add((w.shape[0], stride))
    return worst, kinds


def _conv_calls(model, tree, images, sp):
    """(name, weight, input, stride) of every conv of one forward."""
    from repro_torch.models import convnets as CN

    calls, conv = [], CN._nm_conv_auto

    def spy(leaf, x, sp_cfg, name, stride=1, padding="SAME"):
        calls.append((name, leaf["w"].detach(), x.detach(), stride))
        return conv(leaf, x, sp_cfg, name, stride, padding)

    CN._nm_conv_auto = spy
    try:
        with torch.no_grad():
            CN.apply(model, tree, images, sp)
    finally:
        CN._nm_conv_auto = conv
    return calls


def phase_paper_train(dev, seed):
    """ResNet9, VGG19 and ViT at Table I's widths and batch: five timed
    steps, exact launches, a profiled sixth, peak memory, and the first
    site's operands against the pack of its new master."""
    import functools

    from repro_torch.configs import paper_models as PM
    from repro_torch.core import sparsity as S
    from repro_torch.core.operand import PregenOp
    from repro_torch.data import synthetic as D
    from repro_torch.kernels import fused_update as KF
    from repro_torch.kernels import nm_spmm as KS
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST

    sp = S.SparsityConfig(n=2, m=8, method="bdwp")
    out = {}
    for name in PAPER_NAMES:
        pm = PM.PAPER_MODELS[name]
        model = PM.image_model(name, PAPER_WIDTH)
        batch = PAPER_BATCH or pm.batch
        # the paper's lr and weight decay, warmed up over 100 steps, over
        # its epochs of 50,000 images
        opt = sgd.SGDConfig(lr=pm.lr, weight_decay=pm.wd, warmup_steps=100,
                            total_steps=pm.epochs * 50000 // batch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = ST.init_image_train_state(model, sp, seed=seed, device=dev)
        torch.cuda.synchronize()
        n_params = sum(w.numel() for w in sgd.tree_leaves(state["master"]))
        print(f"  {name}: {n_params / 1e6:.2f} M params, init + "
              f"pre-generation {time.perf_counter() - t0:.1f} s")
        icfg = D.ImageTaskConfig(image=pm.image, num_classes=pm.num_classes,
                                 batch=batch, seed=seed)
        batches = [dict(zip(("images", "labels"),
                            D.image_batch(icfg, i, device=dev)))
                   for i in range(PAPER_STEPS + 1)]
        torch.cuda.synchronize()
        step_fn = functools.partial(ST.image_train_step, model=model,
                                    sp_cfg=sp, opt_cfg=opt)
        want = PAPER_LAUNCHES[name]
        KS.launches = KF.launches = KF.launched_sites = 0
        losses, times, per_step = [], [], []
        for batch_d in batches[:PAPER_STEPS]:
            c0 = (KF.launches, KF.launched_sites, KS.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step_fn(state, batch_d)
            loss = float(met["loss"])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            losses.append(loss)
            per_step.append(tuple(a - b for a, b in zip(
                (KF.launches, KF.launched_sites, KS.launches), c0)))
            print(f"  {name} step {len(losses) - 1}: loss {loss:.6f} lr "
                  f"{float(met['lr']):.4g} {times[-1]:.1f} ms "
                  f"({batch / times[-1] * 1e3:.0f} images/s); launches "
                  f"fused_update {per_step[-1][0]} over {per_step[-1][1]} "
                  f"sites (want {want[0]} over {want[1]}), nm_spmm "
                  f"{per_step[-1][2]} (want {want[2]})")
            check(math.isfinite(loss), f"{name}: non-finite loss")
            check(per_step[-1] == want, f"{name}: launch counts")
        launches = {"fused_update": KF.launches,
                    "fused_update_sites": KF.launched_sites,
                    "nm_spmm": KS.launches}
        state, met, prof = profile_train_step(step_fn, state,
                                              batches[PAPER_STEPS])
        check(math.isfinite(float(met["loss"])), f"{name}: non-finite loss")
        peak = torch.cuda.max_memory_allocated()
        site = _site_views(state["master"], sp)[0][0]
        w, op = _leaf_at(state["master"], site), _leaf_at(state["compute"],
                                                          site)
        ff, bp = w.ndim - 2, w.ndim - 1
        vals, idx = S.nm_pack(w, 2, 8, axis=ff)
        bp_want = torch.where(S.nm_mask(w, 2, 8, axis=bp), w, 0.0)
        check(isinstance(op, PregenOp)
              and bits_equal(op.vals, vals.to(torch.bfloat16))
              and bits_equal(op.idx, idx)
              and torch.equal(op.mask, S.nm_mask(w, 2, 8, axis=ff))
              and bits_equal(op.bp, bp_want.to(torch.bfloat16)),
              f"{name}: {site}'s stored operands != the pack of its master")
        print(f"  {name}: {site} {tuple(w.shape)}: vals/idx == nm_pack, "
              "mask == nm_mask along the contraction axis, bp == the "
              "output-axis mask's operand, of the new master")
        steady = sorted(times[1:])
        ms = steady[len(steady) // 2]
        print(f"  {name} batch {batch}: median of steps 1-4 {ms:.1f} "
              f"ms/step, {batch / ms * 1e3:.0f} images/s; "
              f"max_memory_allocated {peak / 2**30:.2f} GiB")
        out[name] = {"losses": losses, "step_ms": times, "ms_per_step": ms,
                     "images_per_s": batch / ms * 1e3, "batch": batch,
                     "params": n_params, "launches": launches,
                     "launches_per_step": per_step,
                     "max_memory_allocated": peak, "profile": prof}
        del state, batches, op, w
    return out


# phases 21-25: the rest of the training dataflow — transposable and
# shared masks and the legacy pregen=False step.  Phase 21's cases:
# label -> (method, mask kind, pregen, pack, compressed)
DATAFLOW_CASES = {
    **{f"{meth} {flow}": (meth, None, flow == "pregen", True, False)
       for meth in ("dense", "srste", "sdgp", "sdwp", "bdwp")
       for flow in ("pregen", "legacy")},
    "bdwp shared": ("bdwp", "shared", True, True, False),
    "bdwp transposable packed": ("bdwp", "transposable", True, True, False),
    "bdwp transposable": ("bdwp", "transposable", True, False, False),
    "bdwp legacy compressed": ("bdwp", None, False, True, True),
}
MASK_KINDS = {None: {}, "shared": dict(granularity="shared"),
              "transposable": dict(transposable=True)}
# phases 22-24 at qwen3-8b TRAIN: label -> (mask kind, pregen, pack)
TRAIN_FLOWS = {"transposable": ("transposable", True, True),
               "shared": ("shared", True, False),
               "legacy": (None, False, True)}
# their depth: every published width, 4 of qwen3-8b TRAIN's 8 layers
# (the whole run's time; the selections' cost a layer does not depend
# on depth)
FLOW_LAYERS = 2
# phases 22-23: layer 0's transposable operands are checked on this
# leading block (rows, columns) of each projection
CHECK_BLOCK = (512, 2048)
# phase 25: (model, method) on the legacy dataflow at Table I's batch
PAPER_LEGACY = ([("resnet9", m) for m in ("dense", "srste", "sdgp", "sdwp",
                                          "bdwp")]
                + [("resnet18", "bdwp"), ("resnet50", "bdwp")])


def _fused_path(sp, pregen) -> bool:
    """Does this config's update take the grouped fused_update launch?"""
    return (pregen and sp.method in ("srste", "bdwp") and not sp.is_dense
            and sp.granularity == "element" and not sp.transposable)


def _on_device(state, dev) -> bool:
    from repro_torch.optim import sgd

    return all(t.device == torch.device(dev)
               for t in sgd.tree_leaves(state["master"]))


def phase_dataflow_small(dev, seed):
    """qwen3-8b SMOKE, three steps on the card and on the CPU for every
    method on both dataflows, shared and transposable masks and the
    legacy compressed step (P = 2): step-0 compute trees bitwise, losses
    within SMALL_LOSS_ATOL, and the fused_update launches a step where
    (and only where) the reference's fused path runs."""
    from repro_torch.configs import qwen3_8b as C
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.synthetic import lm_stream
    from repro_torch.kernels import fused_update as KF
    from repro_torch.kernels import grad_compress as KG
    from repro_torch.models import transformer_lm as T
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST

    cfg = C.SMOKE
    opt = sgd.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
    params = T.init(cfg, seed=seed, device="cpu")
    sync = {}
    worst = 0.0
    for label, (meth, kind, pregen, pack, comp) in DATAFLOW_CASES.items():
        sp = SparsityConfig(n=2, m=8, method=meth, **MASK_KINDS[kind])
        pods = SYNC_PODS if comp else 1
        states = {d: ST.train_state_from_params(
            sgd.tree_map(lambda _, t: t.to(d, copy=True), params), sp,
            pregen=pregen, pregen_pack=pack, compress=comp, n_pods=pods)
            for d in ("cpu", dev)}
        if pregen:
            check(_compute_bitwise(states["cpu"]["compute"],
                                   states[dev]["compute"]),
                  f"dataflow {label}: step-0 compute trees differ")
        else:
            check("compute" not in states[dev],
                  f"dataflow {label}: a legacy state holds a compute tree")
        streams = {d: lm_stream(cfg.vocab, 2 * pods, 16, device=d,
                                seed=seed) for d in states}
        losses = {d: [] for d in states}
        want_fused = 1 if _fused_path(sp, pregen) else 0
        KG.launches.update({k: 0 for k in KG.launches})
        for step in range(3):
            for d in states:
                _, batch = next(streams[d])
                f0 = KF.launches
                states[d], met = ST.lm_train_step(
                    states[d], batch, cfg=cfg, sp_cfg=sp, opt_cfg=opt,
                    pregen=pregen, pregen_pack=pack, compress=comp,
                    n_pods=pods)
                losses[d].append(float(met["loss"]))
                if d == dev:
                    check(KF.launches - f0 == want_fused,
                          f"dataflow {label}: {KF.launches - f0} "
                          f"fused_update launches a step, want {want_fused}")
        if comp:
            sync = dict(KG.launches)
            check(sync["grad_compress"] > 0
                  and sync["grad_decompress_mean"] > 0,
                  f"dataflow {label}: the sync kernels did not run")
        check(_on_device(states[dev], dev) and ("compute" in states[dev])
              == pregen, f"dataflow {label}: the card state moved or "
              "changed its dataflow")
        diffs = [abs(a - b) for a, b in zip(losses["cpu"], losses[dev])]
        worst = max(worst, *diffs)
        print(f"  {label:26s} losses card "
              + " ".join(f"{x:.5f}" for x in losses[dev]) + "  |d| "
              + " ".join(f"{x:.2e}" for x in diffs)
              + f"; fused_update {want_fused} a step"
              + (f"; grad_compress {sync['grad_compress']}, "
                 f"grad_decompress_mean {sync['grad_decompress_mean']} "
                 "launches in 3 steps" if comp else ""))
        check(all(math.isfinite(x) for x in losses[dev]),
              f"dataflow {label}: non-finite loss")
        check(all(x <= t for x, t in zip(diffs, SMALL_LOSS_ATOL)),
              f"dataflow {label}: losses disagree")
    _paper_legacy_small(dev, seed)
    return worst, sync


def _paper_legacy_small(dev, seed):
    """Phase 21's image part, the legacy dataflow (the fp32 master into
    masked_conv, the conv decay masks re-derived in the update) under
    each of Fig. 4's five methods.  Phase 19's small ResNet9, three
    steps, each on the card from a copy of the CPU run's state before
    it: the card's whole step runs (no nm_spmm or fused_update launch,
    no compute tree), its loss within PAPER_SMALL_LOSS_ATOL of the CPU's,
    and the update of that state given the CPU's gradients bitwise the
    CPU's update.  (Free-running, this ResNet9 does not hold a
    trajectory: a 1e-6 relative nudge of its initial weights moves the
    srste step-2 loss on the CPU by 2.9e-2; PERF.md, PR 20.)  Then phase
    19's ResNet18 check under each method: logits, the gradients (not
    held for SDGP) and each of its 20 convs alone."""
    import functools

    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data import synthetic as D
    from repro_torch.kernels import fused_update as KF
    from repro_torch.kernels import nm_spmm as KS
    from repro_torch.models import convnets as CN
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST

    model = CN.ImageModel("resnet9", 10, 16)
    opt = sgd.SGDConfig(lr=0.02, warmup_steps=2, total_steps=50)
    params = CN.init(model, seed=seed, device="cpu")
    icfg = D.ImageTaskConfig(image=32, num_classes=10,
                             batch=PAPER_SMALL_ROWS, seed=seed)

    def to(state, d):
        return {"master": sgd.tree_map(lambda _, t: t.to(d, copy=True),
                                       state["master"]),
                "momentum": sgd.tree_map(lambda _, t: t.to(d, copy=True),
                                         state["momentum"]),
                "step": state["step"]}

    methods = ("dense", "srste", "sdgp", "sdwp", "bdwp")
    for meth in methods:
        sp = SparsityConfig(n=2, m=8, method=meth)
        label = f"resnet9 {meth} legacy"
        cpu = ST.train_state_from_params(
            sgd.tree_map(lambda _, t: t.clone(), params), sp, pregen=False)
        step = functools.partial(ST.image_train_step, model=model,
                                 sp_cfg=sp, opt_cfg=opt, pregen=False)
        diffs, losses = [], []
        for i in range(3):
            images, labels = D.image_batch(icfg, i, device="cpu")
            batch = {"images": images, "labels": labels}
            c0 = (KS.launches, KF.launches)
            card, met = step(to(cpu, dev), {k: v.to(dev)
                                            for k, v in batch.items()})
            check((KS.launches, KF.launches) == c0,
                  f"{label}: nm_spmm or fused_update launched")
            check(_on_device(card, dev) and "compute" not in card,
                  f"{label}: the card state moved or holds a compute tree")
            loss, grads = ST.image_loss_and_grads(cpu["master"], batch,
                                                  model=model, sp_cfg=sp)
            same = to(cpu, dev)
            g_dev = sgd.tree_map(lambda _, t: t.to(dev, copy=True), grads)
            upd, _ = sgd.update(same, g_dev, opt, sp, pregen=False)
            cpu, _ = sgd.update(cpu, grads, opt, sp, pregen=False)
            check(all(bits_equal(a.cpu(), b) for a, b in zip(
                sgd.tree_leaves({k: upd[k] for k in ("master", "momentum")}),
                sgd.tree_leaves({k: cpu[k] for k in ("master", "momentum")})
            )), f"{label}: step {i}'s update given the same gradients "
                "differs on the card")
            losses.append(float(met["loss"]))
            diffs.append(abs(losses[-1] - float(loss)))
        print(f"  {label:26s} losses card "
              + " ".join(f"{x:.5f}" for x in losses) + "  |d| "
              + " ".join(f"{x:.2e}" for x in diffs)
              + f" (tol {PAPER_SMALL_LOSS_ATOL}, each step from the CPU's "
              "state); the update given the CPU's gradients bitwise")
        check(all(math.isfinite(x) for x in losses),
              f"{label}: non-finite loss")
        check(all(x <= t for x, t in zip(diffs, PAPER_SMALL_LOSS_ATOL)),
              f"{label}: losses disagree")
    images, _ = D.image_batch(D.ImageTaskConfig(
        image=32, num_classes=16, batch=4, seed=seed), 0, device="cpu")
    for meth in methods:
        sp = SparsityConfig(n=2, m=8, method=meth)
        # SDGP's backward selects on the gradient itself: a near-tie of
        # the incoming gradient, one ulp apart on card and CPU, flips a
        # selection and the model's gradients part upstream of it; so
        # its gradients are held conv by conv, each fed the CPU's
        # incoming gradient (PERF.md)
        master = _resnet18_card_vs_cpu(dev, seed, sp,
                                       f"resnet18 {meth} legacy",
                                       whole_grads=not sp.prunes_bp_grads())
        if sp.prunes_bp_grads():
            _sdgp_layer_by_layer(dev, seed, sp, master,
                                 f"resnet18 {meth} legacy")
        calls = _conv_calls(CN.ImageModel("resnet18", 16, 8), master,
                            images.to(torch.bfloat16), sp)
        worst, _ = _convs_card_vs_cpu(dev, calls, sp,
                                      torch.Generator().manual_seed(seed))
        print(f"    its {len(calls)} convs one by one: y/dx/dw worst "
              f"{worst:.3e} of the largest (tol {2.0 ** -7:.3e})")
        check(worst <= 2.0 ** -7,
              f"resnet18 {meth} legacy: a conv differs between card and CPU")


def _time_transposable_masks(master, sp):
    """Wall ms of ``nm_mask_transposable`` over every site's fp32 master,
    on a synchronised clock (the update's mask work alone)."""
    from repro_torch.core import sparsity as S

    views = [w for _, w in _site_leaves(master, sp)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in views:
        S.nm_mask_transposable(w, sp.n, sp.m)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), len(views)


def _check_layer0(state, sp, kind, label, dev):
    """Layer 0's stored operands, written on the card, against the masks
    that the plain selection gives on a CPU copy of its new master.  A
    transposable mask is checked on the leading CHECK_BLOCK rows and
    columns of each projection (its m x m tiles are independent, and the
    CPU selection takes about 0.4 us an element)."""
    from repro_torch.core import sparsity as S

    layer = state["compute"]["blocks"][0]
    master = state["master"]["blocks"][0]
    for part, name in PROJ_PATHS:
        op, w = layer[part][name]["w"], master[part][name]["w"]
        check(op.bp.device == w.device == torch.device(dev),
              f"{label}: layer 0's state left the card")
        rows, cols = (CHECK_BLOCK if kind == "transposable"
                      else tuple(w.shape))
        packed = rows * sp.n // sp.m

        def cpu(t, r=rows):
            return None if t is None else t[:r, :cols].cpu()

        w, bp16, mask = cpu(w), cpu(op.bp), cpu(op.mask)
        if kind == "transposable":
            tm = S.nm_mask_transposable(w, sp.n, sp.m)
            bp = torch.where(tm, w, 0.0).to(torch.bfloat16)
            ok = torch.equal(mask, tm) and bits_equal(bp16, bp) \
                and op.ff is None
            if op.is_packed:
                vals, idx = S.nm_pack_from_mask(bp, tm, sp.n, sp.m, axis=0)
                ok = ok and bits_equal(cpu(op.vals, packed), vals) \
                    and torch.equal(cpu(op.idx, packed), idx)
        else:
            ffm = S.nm_mask_shared(w, sp.n, sp.m, 0, 1, sp.tile)
            bpm = S.nm_mask_shared(w, sp.n, sp.m, 1, 0, sp.tile)
            ok = (torch.equal(mask, ffm) and bits_equal(
                cpu(op.ff), torch.where(ffm, w, 0.0).to(torch.bfloat16))
                and bits_equal(bp16, torch.where(bpm, w, 0.0).to(
                    torch.bfloat16)) and not op.is_packed)
        check(ok, f"{label}: layer 0 {name}'s operands != the masks of a "
              "CPU copy of its new master")
    print(f"  layer 0: every projection's stored operands == the {kind} "
          "masks of a CPU copy of its new fp32 master"
          + (" (leading {} x {} block)".format(*CHECK_BLOCK)
             if kind == "transposable" else ""))


def _shared_pack_kept_mass(state, sp, dev):
    """PERF.md's open question: the share of each trained FF operand's
    surviving |w| mass that ``pack_tree_shared``'s one row pattern per
    weight keeps, at F > 128 (shared masks pick per 128 columns)."""
    from repro_torch.core import bdwp
    from repro_torch.core.operand import SharedOp
    from repro_torch.kernels import nm_compact as KC

    c0 = KC.launches
    packed = bdwp.pack_tree_shared(state["master"], sp, device=dev)
    torch.cuda.synchronize()
    shares = []
    for layer, (cl, pl) in enumerate(zip(state["compute"]["blocks"],
                                         packed["blocks"])):
        for part, name in PROJ_PATHS:
            op, sop = cl[part][name]["w"], pl[part][name]["w"]
            check(isinstance(sop, SharedOp), "shared pack: not a SharedOp")
            mass = op.ff.float().abs()
            kept = float(mass.index_select(0, sop.idx).sum())
            shares.append((name, layer, kept / float(mass.sum()),
                           op.ff.shape[1]))
    vals = sorted(s for _, _, s, _ in shares)
    print(f"  pack_tree_shared on the trained master ({KC.launches - c0} "
          f"nm_compact launches): of each FF operand's surviving |w| mass "
          f"the one-pattern pack keeps min {vals[0]:.4f}, median "
          f"{vals[len(vals) // 2]:.4f}, max {vals[-1]:.4f} over "
          f"{len(vals)} operands ({sum(f > 128 for *_, f in shares)} with "
          "F > 128)")
    widths = {name: f for name, _, _, f in shares}
    for _, name in PROJ_PATHS:
        per = [s for n, _, s, _ in shares if n == name]
        print(f"    {name:8s} F {widths[name]:6d}: mean "
              f"{sum(per) / len(per):.4f} over {len(per)} layers")
    return {"min": vals[0], "median": vals[len(vals) // 2],
            "max": vals[-1], "per_operand": shares}


def phase_train_flow(dev, seed, flow):
    """qwen3-8b TRAIN at FLOW_LAYERS layers, 2:8 bdwp on one of
    TRAIN_FLOWS: five timed steps
    with exact launches (nm_spmm 2 x 7 x L a step for the packed
    transposable FF, else 0; fused_update 0: these sites stay off it, as
    in the reference), a profiled sixth, peak memory, and layer 0's
    operands against its new master (the pre-generating flows)."""
    import functools

    from repro_torch.configs import qwen3_8b as C
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.synthetic import lm_stream
    from repro_torch.kernels import fused_update as KF
    from repro_torch.kernels import nm_spmm as KS
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST

    kind, pregen, pack = TRAIN_FLOWS[flow]
    cfg = dataclasses.replace(C.TRAIN, n_layers=FLOW_LAYERS)
    sp = SparsityConfig(n=2, m=8, method="bdwp", **MASK_KINDS[kind])
    opt = sgd.SGDConfig(lr=0.004, warmup_steps=2, total_steps=100)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = ST.init_train_state(cfg, sp, seed=seed, device=dev,
                                pregen=pregen, pregen_pack=pack)
    torch.cuda.synchronize()
    print(f"  init {cfg.n_layers} layers"
          + (" + pre-generation" if pregen else "")
          + f": {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    step_fn = functools.partial(ST.lm_train_step, cfg=cfg, sp_cfg=sp,
                                opt_cfg=opt, pregen=pregen, pregen_pack=pack)
    stream = lm_stream(cfg.vocab, *TRAIN_ROWS, device=dev, seed=seed)
    batches = [next(stream)[1] for _ in range(6)]
    want = (2 * 7 * cfg.n_layers if kind == "transposable" and pack
            else 0, 0)
    tokens = TRAIN_ROWS[0] * TRAIN_ROWS[1]
    KS.launches = KF.launches = KF.launched_sites = 0
    losses, times, per_step = [], [], []
    for batch in batches[:5]:
        c0 = (KS.launches, KF.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        per_step.append((KS.launches - c0[0], KF.launches - c0[1]))
        print(f"  step {len(losses) - 1}: loss {loss:.6f} {times[-1]:.1f} ms "
              f"({tokens / times[-1] * 1e3:.0f} tok/s); launches nm_spmm "
              f"{per_step[-1][0]} (want {want[0]}), fused_update "
              f"{per_step[-1][1]} (want {want[1]})")
        check(math.isfinite(loss), f"train {flow}: non-finite loss")
        check(per_step[-1] == want, f"train {flow}: launch counts")
        check(("compute" in state) == pregen,
              f"train {flow}: the state's compute tree")
    launches = {"nm_spmm": KS.launches, "fused_update": KF.launches}
    state, met, prof = profile_train_step(step_fn, state, batches[5])
    check(math.isfinite(float(met["loss"])), f"train {flow}: non-finite")
    check(_on_device(state, dev), f"train {flow}: the state left the card")
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(times[1:])
    ms = steady[len(steady) // 2]
    print(f"  {cfg.name} x{cfg.n_layers} layers, {flow}: median of steps "
          f"1-4 {ms:.1f} ms/step, {tokens / ms * 1e3:.0f} tokens/s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    out = {"losses": losses, "step_ms": times, "ms_per_step": ms,
           "tokens_per_s": tokens / ms * 1e3, "launches": launches,
           "launches_per_step": per_step, "max_memory_allocated": peak,
           "profile": prof}
    if pregen:
        _check_layer0(state, sp, kind, f"train {flow}", dev)
    if kind == "transposable":
        mask_ms, sites = _time_transposable_masks(state["master"], sp)
        upd = prof["parts"].get("train/update", {})
        rng = prof["parts"].get("sgd/nm_mask_transposable", {})
        print(f"  nm_mask_transposable (plain PyTorch) over the {sites} "
              f"sites alone: {mask_ms:.1f} ms of wall; in the profiled "
              f"update: device {rng.get('device_ms', 0):.1f} of "
              f"{upd.get('device_ms', 0):.1f} ms, host "
              f"{rng.get('host_ms', 0):.1f} of {upd.get('host_ms', 0):.1f} ms")
        out["nm_mask_transposable_ms"] = mask_ms
    if kind == "shared":
        out["shared_pack"] = _shared_pack_kept_mass(state, sp, dev)
    del state, batches
    return out


def phase_paper_legacy(dev, seed):
    """The paper's models on the legacy dataflow at Table I's widths and
    batch: ResNet9 under each of Fig. 4's five methods, ResNet18 and
    ResNet50 under 2:8 bdwp; five timed steps each (batches drawn before
    the clock) with finite losses and no nm_spmm or fused_update launch
    (the reference reaches neither on this dataflow).  A batch that does
    not fit the card is halved until it does, and said so."""
    from repro_torch.configs import paper_models as PM
    from repro_torch.core.sparsity import SparsityConfig

    out = {}
    for name, meth in PAPER_LEGACY:
        pm = PM.PAPER_MODELS[name]
        model = PM.image_model(name, PAPER_WIDTH)
        sp = SparsityConfig(n=2, m=8, method=meth)
        batch = PAPER_BATCH or pm.batch
        cuts = []
        while True:
            try:
                out[f"{name}/{meth}"] = _paper_legacy_run(
                    dev, seed, pm, model, sp, batch)
                break
            except torch.OutOfMemoryError:
                peak = torch.cuda.max_memory_allocated()
                torch.cuda.empty_cache()
                print(f"  {name} {meth}: batch {batch} does not fit the "
                      f"card (out of memory at max_memory_allocated "
                      f"{peak / 2**30:.2f} GiB); cut to {batch // 2}")
                cuts.append({"batch": batch, "peak": peak})
                check(batch > 1, f"{name}: no batch fits")
                batch //= 2
        out[f"{name}/{meth}"]["cuts"] = cuts
    return out


def _paper_legacy_run(dev, seed, pm, model, sp, batch):
    """Phase 25's run of one model and method at one batch."""
    import functools

    from repro_torch.data import synthetic as D
    from repro_torch.kernels import fused_update as KF
    from repro_torch.kernels import nm_spmm as KS
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST

    opt = sgd.SGDConfig(lr=pm.lr, weight_decay=pm.wd, warmup_steps=100,
                        total_steps=pm.epochs * 50000 // batch)
    label = f"{model.name} {sp.method}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = ST.init_image_train_state(model, sp, seed=seed, device=dev,
                                      pregen=False)
    icfg = D.ImageTaskConfig(image=pm.image, num_classes=pm.num_classes,
                             batch=batch, seed=seed)
    t0 = time.perf_counter()
    batches = [dict(zip(("images", "labels"),
                        D.image_batch(icfg, i, device=dev)))
               for i in range(PAPER_STEPS)]
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    step_fn = functools.partial(ST.image_train_step, model=model, sp_cfg=sp,
                                opt_cfg=opt, pregen=False)
    KS.launches = KF.launches = 0
    losses, times = [], []
    for batch_d in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step_fn(state, batch_d)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        check(math.isfinite(loss), f"{label}: non-finite loss")
        check("compute" not in state, f"{label}: a compute tree appeared")
    check(KS.launches == 0 and KF.launches == 0,
          f"{label}: nm_spmm {KS.launches} / fused_update {KF.launches} "
          "launches on the legacy dataflow, want 0 / 0")
    check(_on_device(state, dev), f"{label}: the state left the card")
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(times[1:])
    ms = steady[len(steady) // 2]
    print(f"  {label:16s} batch {batch} ({pm.image} px, "
          f"{pm.num_classes} classes): losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; median of steps 1-4 {ms:.1f} ms/step, "
          f"{batch / ms * 1e3:.0f} images/s; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; batches drawn in {draw_s:.1f} s")
    del state, batches
    return {"losses": losses, "step_ms": times, "ms_per_step": ms,
            "images_per_s": batch / ms * 1e3, "batch": batch,
            "max_memory_allocated": peak,
            "launches": {"nm_spmm": KS.launches,
                         "fused_update": KF.launches}}


# ---------------------------------------------------------------------------
# Fig. 4 on the card, and the rest of the dense LM family
# ---------------------------------------------------------------------------

ARCH_IDS = ("qwen2.5-32b", "glm4-9b", "gemma3-12b", "internvl2-26b")
# TRAIN rows per arch: (sequences, text tokens a sequence, prefix rows)
ARCH_TRAIN_ROWS = {"qwen2.5-32b": (4, 512, 0), "glm4-9b": (4, 512, 0),
                   "gemma3-12b": (2, 2048, 0),
                   "internvl2-26b": (2, 1024, 1024)}
# card vs CPU SMOKE logits: as SMALL_ATOL, but for the two archs whose
# reference itself moves further under a one-ulp nudge of one weight
# (tests/test_torch_archs.py: gemma3's 6 layers, internvl2 without
# qk_norm)
ARCH_SMALL_ATOL = {"gemma3-12b": 6e-2, "internvl2-26b": 4e-2}
ARCH_DECODE_STEPS = 20          # SMOKE decode steps: > gemma3's window 16
# gemma3 FULL serving with prompts past its 1024-token window
GEMMA_LONG = dict(lens=(1100, 1200, 1150, 1180, 1120, 1199),
                  new=(8, 24, 16, 12, 20, 10),
                  serve_kw=dict(n_slots=4, prompt_bucket=1280, max_len=1344))
FIG4_LR0_SEEDS = (0, 1)         # Fig. 4's control runs at lr 0
CURSOR_STEPS = 16               # shared-cursor decode steps (gemma3)
# shared cursor vs per slot over CURSOR_STEPS decode steps, of the
# largest |logit| (NVIDIA H100 80GB HBM3, 700 W: sound 1.4e-2 to 1.5e-2;
# planted faults: window ignored 1.6e-1, caught; off by one 2.9e-2, left
# to the check below)
CURSOR_RTOL = 5e-2
# one layer's decode attention, shared cursor vs per slot (same query
# and cache): of the largest and of the mean |output| (the same card:
# sound 2.9e-3 and 7.9e-7; the off-by-one fault's smallest layer 3.2e-3
# and 6.7e-4)
CURSOR_ATTN_MAX_RTOL, CURSOR_ATTN_MEAN_RTOL = 2 ** -7, 2 ** -14
VLM_ROWS = (2, 64, 1024)        # internvl2 FULL: prompts, text, prefix
# phase 30's serving depth: every published width, a quarter of the
# layers (gemma3: two 5:1 periods); at full depth the engine runs' solo
# reruns took most of the whole run's time
ARCH_SERVE_LAYERS = {"qwen2.5-32b": 8, "glm4-9b": 5, "gemma3-12b": 6,
                     "internvl2-26b": 6}


def phase_fig4(dev):
    """Fig. 4 on the card: ResNet9 (width 32, batch 64, lr 0.05, 10
    warmup steps, 120 steps, 2:8, legacy dataflow) under the five
    methods and the reference's seeds, held to the reference's committed
    curves as ``examples/torch_paper_loss_curves.check_curves`` holds
    them (enough runs that learn, each method's tail-20 mean in its band,
    the ordering as the reference reads where it resolves it); the same
    check must reject runs that do not learn: FIG4_LR0_SEEDS runs of each
    method at lr 0, and flat chance-level and frozen curves; then Table
    I's lr (0.5, 100 warmup steps) at seed 0 beside the reference's
    curves."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "examples"))
    import torch_paper_loss_curves as E

    ref = E.load_reference()
    t0 = time.perf_counter()
    curves = {m: {str(s): E.train_resnet9(m, steps=ref["steps"], seed=s,
                                          device=dev)
                  for s in ref["seeds"]} for m in E.METHODS}
    secs = time.perf_counter() - t0
    runs = len(E.METHODS) * len(ref["seeds"])
    print(f"  {len(E.METHODS)} methods x {len(ref['seeds'])} seeds x "
          f"{ref['steps']} steps in {secs:.1f} s "
          f"({1e3 * secs / (runs * ref['steps']):.1f} ms/step with the "
          "batch draws)")
    ok = E.check_curves(curves, ref)
    check(ok, "fig4: too few runs learn, a tail mean outside the "
          "reference's band, or the ordering reads otherwise")
    lr0 = {m: {str(s): E.train_resnet9(m, steps=ref["steps"], seed=s,
                                       device=dev, lr={"lr": 0.0,
                                                       "warmup_steps": 10})
               for s in FIG4_LR0_SEEDS} for m in E.METHODS}
    check(E.controls_rejected(ref, FIG4_LR0_SEEDS, extra={
        f"lr 0 ({len(FIG4_LR0_SEEDS)} seeds a method)": lr0}),
        "fig4: the check accepts runs that do not learn")
    print(f"  Table I's lr ({E.TABLE1_LR['lr']}, "
          f"{E.TABLE1_LR['warmup_steps']} warmup steps), seed 0:")
    table1 = {m: {"0": E.train_resnet9(m, steps=ref["steps"], seed=0,
                                       device=dev, lr=E.TABLE1_LR)}
              for m in E.METHODS}
    E.report_table1(table1, ref)
    check(all(math.isfinite(x) for v in table1.values() for c in v.values()
              for x in c),
          "fig4: a non-finite loss at Table I's lr")
    return {"curves": curves, "table1_lr": table1, "seconds": secs,
            "lr0_tails": {m: [E.tail_mean(c) for c in v.values()]
                          for m, v in lr0.items()},
            "tails": {m: [E.tail_mean(c) for c in v.values()]
                      for m, v in curves.items()}}


def arch_proj(cfg):
    """The seven projection shapes (name, K, F) of one layer of ``cfg``."""
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv * cfg.head_dim
    d, ff = cfg.d_model, cfg.d_ff
    return [("q_proj", d, q), ("k_proj", d, kv), ("v_proj", d, kv),
            ("o_proj", q, d), ("w_gate", d, ff), ("w_up", d, ff),
            ("w_down", ff, d)]


def spmm_case_checks(dev, gen, label, cases):
    """nm_spmm at ``cases`` [(name, B, K, F, idx bits)] within the
    phase-3 tolerance of the plain version, deterministic, row 0 bitwise
    the B = 1 result; timed (CUDA graph replay) beside dense torch.matmul
    and the plain version, against the bound.  Returns (rows, max abs
    err)."""
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels import ref

    rows, worst = [], 0.0
    for name, b, k, f, bits in cases:
        act, vals, idx = packed_case(gen, b, k, f, 2, 8, bits, dev)
        kern = K.nm_spmm(act, vals, idx, 2, 8, idx_bits=bits)
        again = K.nm_spmm(act, vals, idx, 2, 8, idx_bits=bits)
        row0 = K.nm_spmm(act[:1].contiguous(), vals, idx, 2, 8,
                         idx_bits=bits)
        plain = ref.ref_nm_spmm(act, vals, idx, 2, 8, idx_bits=bits)
        w = ref.decompress_nm(vals, idx, 2, 8, axis=0, idx_bits=bits)
        err = (kern - plain).abs()
        scale = act.float().abs() @ w.float().abs()
        case = f"{label} {name} B={b} u{bits}"
        check(float((err - TOL * scale).max()) <= 0,
              f"nm_spmm {case}: error above tolerance")
        check(torch.equal(kern, again), f"nm_spmm {case}: not deterministic")
        check(torch.equal(kern[:1], row0),
              f"nm_spmm {case}: row 0 depends on the batch")
        worst = max(worst, float(err.max()))
        wb = w.to(torch.bfloat16)
        del plain, scale, err, w, kern, again, row0
        t_k = time_ms(lambda i: K.nm_spmm(act, vals, idx, 2, 8, bits), 1,
                      iters=5)
        t_l = time_ms(lambda i: torch.matmul(act, wb), 1, iters=5)
        t_p = time_ms(lambda i: ref.ref_nm_spmm(act, vals, idx, 2, 8,
                                                idx_bits=bits), 1, iters=1)
        t_b, by = bound_ms(act, vals, idx, f)
        pl = K.plan(b, k, f, 2, 8)
        rows.append({"proj": name, "B": b, "K": k, "F": f, "idx_bits": bits,
                     "ms": t_k, "library_ms": t_l, "plain_ms": t_p,
                     "bound_ms": t_b, "bound_by": by,
                     "chunk_groups": pl.chunk_groups,
                     "stage_groups": pl.gs, "config": pl.config,
                     "splits": pl.splits})
        print(f"  {label} nm_spmm {name:20s} B={b:5d} {k:4d}x{f:<4d} u{bits}: "
              f"kernel {t_k:.4f} ms, torch.matmul (dense bf16) {t_l:.4f} "
              f"ms, bound {t_b:.4f} ms ({by}), plain {t_p:.3f} ms; config "
              f"{pl.config}, split-K {pl.splits}")
        del act, vals, idx, wb
        torch.cuda.empty_cache()
    return rows, worst


def proj_kernel_checks(dev, gen, label, proj, train_rows):
    """nm_spmm and nm_compact at one arch's projection shapes ``proj``
    [(name, K, F)]: nm_spmm at decode rows (B = 4, u4) and at
    ``train_rows`` (u8) through ``spmm_case_checks``; then nm_compact of
    each weight as the element pack reads it, u4, vector and scalar
    variants, bitwise.  Returns (rows, nm_spmm's max abs err)."""
    rows, worst = spmm_case_checks(
        dev, gen, label, [(name, b, k, f, bits) for name, k, f in proj
                          for b, bits in ((4, 4), (train_rows, 8))])
    for b in sorted({r["B"] for r in rows}):
        rs = [r for r in rows if r["B"] == b]
        print(f"  {label} nm_spmm B={b}: one layer's {len(proj)} "
              f"projections kernel {sum(r['ms'] for r in rs):.4f} ms, dense "
              f"torch.matmul {sum(r['library_ms'] for r in rs):.4f} ms,"
              f" bound {sum(r['bound_ms'] for r in rs):.4f} ms; "
              "chunk/stage groups "
              + ", ".join(f"{r['proj']} {r['chunk_groups']}/"
                          f"{r['stage_groups']}" for r in rs))
    torch.cuda.empty_cache()
    for name, k, f in proj:
        w = torch.randn((k, f), generator=gen, device=dev).to(torch.bfloat16)
        check_compact_view(w.t(), 2, 8, 4, ("vector", "scalar"),
                           f"{label} {name} u4")
        del w
    return rows, worst


def phase_arch_kernels(dev, gen):
    """Each new arch's seven projection shapes through
    ``proj_kernel_checks`` at its TRAIN step's rows; one layer's 7 sites
    in one grouped fused_update launch, bitwise the per-site plain
    version (out of place and in place)."""
    from repro_torch.configs import get_arch

    out, worst = {}, {"nm_spmm": 0.0, "fused_update": 0.0}
    for arch_id in ARCH_IDS:
        cfg = get_arch(arch_id).full
        b_seq, text, prefix = ARCH_TRAIN_ROWS[arch_id]
        proj = arch_proj(cfg)
        rows, err = proj_kernel_checks(dev, gen, arch_id, proj,
                                       b_seq * (text + prefix))
        worst["nm_spmm"] = max(worst["nm_spmm"], err)
        worst["fused_update"] = max(worst["fused_update"], grouped_update_check(
            gen, [(k, f) for _, k, f in proj], dev, UPDATE_SCALARS,
            f"{arch_id} layer"))
        print(f"  {arch_id}: nm_spmm within tolerance, rows independent of "
              "B; one grouped fused_update over the 7 sites bitwise (in "
              "place too); nm_compact of the 7 weights bitwise (u4, vector "
              "and scalar)")
        out[arch_id] = rows
        torch.cuda.empty_cache()
    return worst, out


def _grow_cache(cfg, cache, max_len, dev):
    """A prefill cache copied into a deeper one (its positions first):
    every tensor of each layer's cache (k/v, or MLA's ckv/kpe), the
    prelude's too."""
    from repro_torch.models import transformer_lm as T

    b = next(iter(cache["layers"][0].values())).shape[0]
    out = T.init_lm_cache(cfg, b, max_len, device=dev)
    pairs = list(zip(out["layers"], cache["layers"]))
    if "prelude" in cache:
        pairs.append((out["prelude"], cache["prelude"]))
    for dst, src in pairs:
        for key, t in src.items():
            if isinstance(t, torch.Tensor):
                dst[key][:, :t.shape[1]] = t
            else:
                dst[key] = t
    return out


def phase_arch_small(dev, seed):
    """Each new arch at SMOKE size, card vs CPU: forward logits; three
    BDWP packed pre-generating train steps (step-0 compute trees bitwise,
    losses within SMALL_LOSS_ATOL); prefill (internvl2 with a prefix)
    and ARCH_DECODE_STEPS decode steps per slot and with the shared
    cursor from 2:8 u4-packed weights, logits within the arch's
    tolerance."""
    from repro_torch.configs import get_arch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.synthetic import lm_stream
    from repro_torch.models import transformer_lm as T
    from repro_torch.optim import sgd
    from repro_torch.serve.packed_params import pack_tree_element
    from repro_torch.train import step as ST

    sp = SparsityConfig(n=2, m=8, method="bdwp")
    opt = sgd.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
    for arch_id in ARCH_IDS:
        arch = get_arch(arch_id)
        cfg, atol = arch.smoke, ARCH_SMALL_ATOL.get(arch_id, SMALL_ATOL)
        prefix = 8 if arch.prefix_len else 0
        params = T.init(cfg, seed=seed, device="cpu")
        streams = {d: lm_stream(cfg.vocab, 2, 32, device=d, seed=seed,
                                prefix=prefix, d_model=cfg.d_model)
                   for d in ("cpu", dev)}
        batch0 = {d: next(streams[d])[1] for d in streams}
        logits = {}
        with torch.no_grad():
            for d in streams:
                p16 = sgd.tree_map(lambda _, t: t.to(d, torch.bfloat16),
                                   params)
                h, _, _ = T.forward(
                    p16, batch0[d]["tokens"], cfg, sp,
                    prefix_embeds=batch0[d].get("prefix_embeds"))
                logits[d] = T.logits_from_hidden(p16, h, cfg)
        d_fwd = float((logits[dev].cpu() - logits["cpu"]).abs().max())
        check(d_fwd <= atol, f"{arch_id} small: forward logits disagree")
        states = {d: ST.train_state_from_params(
            sgd.tree_map(lambda _, t: t.to(d, copy=True), params), sp)
            for d in streams}
        check(_compute_bitwise(states["cpu"]["compute"],
                               states[dev]["compute"]),
              f"{arch_id} small: step-0 compute trees differ")
        losses = {d: [] for d in streams}
        for i in range(3):
            for d in streams:
                batch = batch0[d] if i == 0 else next(streams[d])[1]
                states[d], met = ST.lm_train_step(states[d], batch, cfg=cfg,
                                                  sp_cfg=sp, opt_cfg=opt)
                losses[d].append(float(met["loss"]))
        diffs = [abs(a - b) for a, b in zip(losses[dev], losses["cpu"])]
        check(all(math.isfinite(x) for x in losses[dev]),
              f"{arch_id} small: non-finite loss")
        check(all(x <= t for x, t in zip(diffs, SMALL_LOSS_ATOL)),
              f"{arch_id} small: training losses disagree")
        packed = {d: pack_tree_element(
            sgd.tree_map(lambda _, t: t.to(torch.bfloat16), params), sp,
            device=d)[0] for d in streams}
        worst = {}
        for mode in ("per_slot", "shared"):
            worst[mode] = _small_decode(dev, seed, cfg, sp, packed, prefix,
                                        mode == "per_slot")
            check(worst[mode] <= atol,
                  f"{arch_id} small: {mode} decode logits disagree")
        print(f"  {arch_id} SMOKE: forward |dlogit| {d_fwd:.3e}; step-0 "
              f"compute trees bitwise; losses card "
              + " ".join(f"{x:.5f}" for x in losses[dev]) + " |d| "
              + " ".join(f"{x:.2e}" for x in diffs)
              + f" (tol {SMALL_LOSS_ATOL}); prefill + {ARCH_DECODE_STEPS} "
              f"decode steps per slot {worst['per_slot']:.3e}, shared cursor "
              f"{worst['shared']:.3e} (tol {atol})")


def _small_decode(dev, seed, cfg, sp, packed, prefix, per_slot):
    """Prefill 2 prompts (after ``prefix`` rows) and ARCH_DECODE_STEPS
    decode steps on card and CPU, teacher-forced by the CPU's argmax:
    the largest |logit| difference."""
    from repro_torch.train import step as ST

    rng = np.random.default_rng(seed)
    lens = (9, 12)
    toks = np.zeros((2, max(lens)), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab, n)
    emb = (torch.from_numpy(rng.standard_normal(
        (2, prefix, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
        if prefix else None)
    last = np.asarray(lens) - 1 + prefix
    s_tot = toks.shape[1] + prefix
    logits, caches, worst = {}, {}, 0.0
    with torch.no_grad():
        for d, p in packed.items():
            batch = {"tokens": torch.from_numpy(toks).to(d)}
            if emb is not None:
                batch["prefix_embeds"] = emb.to(d)
            logits[d], cache = ST.lm_prefill_step(p, batch, cfg=cfg,
                                                  sp_cfg=sp, last_index=last)
            caches[d] = _grow_cache(cfg, cache, s_tot + ARCH_DECODE_STEPS + 1,
                                    d)
        pos = torch.from_numpy(last + 1) if per_slot else s_tot
        for step in range(ARCH_DECODE_STEPS + 1):
            worst = max(worst, float((logits[dev].cpu()
                                      - logits["cpu"]).abs().max()))
            if step == ARCH_DECODE_STEPS:
                break
            tok = torch.argmax(logits["cpu"][:, -1, :cfg.vocab], -1)[:, None]
            for d, p in packed.items():
                logits[d], caches[d] = ST.lm_decode_step(
                    p, caches[d], tok.to(d),
                    pos.to(d) if per_slot else pos, cfg=cfg, sp_cfg=sp,
                    per_slot=per_slot)
            pos = pos + 1
    return worst


def arch_module(arch_id):
    """The port's config module of ``arch_id`` (FULL, SMOKE, TRAIN)."""
    import importlib

    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace(".", "_").replace("-", "_"))


def _cursor_faults(cfg):
    """Planted faults of the shared cursor: {name: the LMConfig its decode
    runs with}.  "window ignored": every layer global; "window off by
    one": each windowed layer slices the last window - 1 positions."""
    return {"window ignored": dataclasses.replace(cfg, pattern=("attn",)),
            "window off by one": dataclasses.replace(cfg,
                                                     window=cfg.window - 1)}


def _attn_rel(a, b):
    """(max |a - b| / max |b|, mean |a - b| / mean |b|) in fp32."""
    d, b = (a.float() - b.float()).abs(), b.float().abs()
    return float(d.max() / b.max()), float(d.mean() / b.mean())


def _cursor_attention_check(dev, cfg, cache, pos):
    """Each layer's decode attention at position ``pos`` over its cache
    from the FULL prefill, one random bf16 query: the shared cursor (an
    int position: a windowed layer slices its last window positions) vs
    per slot (a (B,) position: the window by mask) sum the same products
    over the same keys, so they agree within CURSOR_ATTN_MEAN_RTOL of
    the mean |output| (and CURSOR_ATTN_MAX_RTOL of the largest); each
    planted fault (``_cursor_faults``) must move every windowed layer
    past one of the two."""
    from repro_torch.models import attention as A

    gen = torch.Generator(device=dev).manual_seed(SEED)
    sound, faults = [], {name: [] for name in _cursor_faults(cfg)}
    kinds = cfg.layer_kinds()
    for li, lc in enumerate(cache["layers"]):
        k, v = lc["k"], lc["v"]
        n = k.shape[0]
        q = torch.randn((n, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                        device=dev).to(k.dtype)
        per = A.decode_attention(q, k, v, torch.full((n,), pos, device=dev),
                                 window=cfg.layer_window(kinds[li]))
        sound.append(_attn_rel(A.decode_attention(
            q, k, v, pos, window=cfg.layer_window(kinds[li])), per))
        if kinds[li] == "swa":
            for name, fcfg in _cursor_faults(cfg).items():
                faults[name].append(_attn_rel(A.decode_attention(
                    q, k, v, pos, window=fcfg.layer_window(
                        fcfg.layer_kinds()[li])), per))
    worst = tuple(max(r[i] for r in sound) for i in (0, 1))
    print(f"  shared cursor vs per slot, each of {len(sound)} layers' "
          f"attention at position {pos} (same query and cache): max |d| "
          f"{worst[0]:.3e} of the largest |out| (tol "
          f"{CURSOR_ATTN_MAX_RTOL}), mean |d| {worst[1]:.3e} of the mean "
          f"(tol {CURSOR_ATTN_MEAN_RTOL})")
    check(worst[0] <= CURSOR_ATTN_MAX_RTOL
          and worst[1] <= CURSOR_ATTN_MEAN_RTOL,
          "shared cursor: a layer's attention differs from per-slot decode")
    out = {"sound": worst}
    for name, rows in faults.items():
        lo = tuple(min(r[i] for r in rows) for i in (0, 1))
        hi = tuple(max(r[i] for r in rows) for i in (0, 1))
        caught = sum(r[0] > CURSOR_ATTN_MAX_RTOL
                     or r[1] > CURSOR_ATTN_MEAN_RTOL for r in rows)
        print(f"  planted fault '{name}': max |d| {lo[0]:.3e}..{hi[0]:.3e} "
              f"of the largest, mean |d| {lo[1]:.3e}..{hi[1]:.3e} of the "
              f"mean; caught in {caught} of {len(rows)} windowed layers")
        check(caught == len(rows),
              f"shared cursor: planted fault '{name}' missed in a layer")
        out[name] = {"min": lo, "max": hi}
    return out


def _shared_cursor_run(dev, cfg, sp, store, prompts):
    """gemma3 FULL: 4 prompts cut to one length past the window,
    prefilled together; each layer's attention with the shared cursor
    against per slot on the prefill's cache (``_cursor_attention_check``,
    planted faults included); then CURSOR_STEPS greedy lm_decode_steps
    with the shared cursor, timed, with exactly 7 x L nm_spmm launches a
    step, and the same steps per slot (window by mask) on a copy of the
    cache, fed the same tokens: logits within CURSOR_RTOL of the largest
    |logit|.  The two modes sum the same products over 1024 keys and
    over all the cache's, so an attention output now and then rounds one
    bf16 ulp apart and 48 layers carry it (on the CPU at SMOKE size they
    agree bitwise); the same steps with each planted fault are read
    beside it."""
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.train import step as ST

    n = min(4, len(prompts))
    s = min(len(p) for p in prompts[:n])
    toks = torch.tensor([p[:s] for p in prompts[:n]], device=dev)
    with torch.no_grad():
        logits, cache = ST.lm_prefill_step(store.params, {"tokens": toks},
                                           cfg=cfg, sp_cfg=sp)
        depth = s + CURSOR_STEPS + 1
        attn = _cursor_attention_check(dev, cfg, _grow_cache(
            cfg, cache, depth, dev), s - 1)
        first = torch.argmax(logits[:, -1, :cfg.vocab], -1)[:, None]
        runs = {"shared": (cfg, False), "per_slot": (cfg, True),
                **{name: (fcfg, False)
                   for name, fcfg in _cursor_faults(cfg).items()}}
        out, stream = {}, []
        for mode, (mcfg, per_slot) in runs.items():
            c = _grow_cache(cfg, cache, depth, dev)
            tok, outs = first, []
            K.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(CURSOR_STEPS):
                pos = (torch.full((n,), s + i, device=dev) if per_slot
                       else s + i)
                lg, c = ST.lm_decode_step(store.params, c, tok, pos,
                                          cfg=mcfg, sp_cfg=sp,
                                          per_slot=per_slot)
                outs.append(lg[:, -1, :cfg.vocab])
                if mode == "shared":
                    stream.append(torch.argmax(lg[:, -1, :cfg.vocab],
                                               -1)[:, None])
                tok = stream[i]
            torch.cuda.synchronize()
            out[mode] = (1e3 * (time.perf_counter() - t0) / CURSOR_STEPS,
                         K.launches, outs)
            del c
        del cache
    want = 7 * cfg.n_layers * CURSOR_STEPS
    top = max(float(a.abs().max()) for a in out["per_slot"][2])

    def rel(mode):
        return max(float((a - b).abs().max()) for a, b in zip(
            out[mode][2], out["per_slot"][2])) / top

    diff = rel("shared")
    print(f"  shared cursor: {n} prompts of {s} tokens (window "
          f"{cfg.window}), {CURSOR_STEPS} decode steps "
          f"{out['shared'][0]:.2f} ms/step ({n * 1e3 / out['shared'][0]:.1f} "
          f"tok/s), nm_spmm launches {out['shared'][1]} (want {want}); per "
          f"slot on the same tokens {out['per_slot'][0]:.2f} ms/step; logits"
          f" max |d| {diff:.3e} of the largest |logit| {top:.3f} (tol "
          f"{CURSOR_RTOL}); planted faults "
          + ", ".join(f"'{m}' {rel(m):.3e}" for m in _cursor_faults(cfg)))
    check(out["shared"][1] == want and out["per_slot"][1] == want,
          "shared cursor: nm_spmm launch count")
    check(all(bool(torch.isfinite(x).all()) for x in out["shared"][2]),
          "shared cursor: non-finite logits")
    check(diff <= CURSOR_RTOL,
          "shared cursor and per-slot decode disagree")
    check(rel("window ignored") > CURSOR_RTOL,
          "shared cursor: the logits check misses a decode that ignores "
          "the window")
    return {"prompt_len": s, "rows": n, "ms_per_step": out["shared"][0],
            "per_slot_ms_per_step": out["per_slot"][0],
            "launches": out["shared"][1] + out["per_slot"][1],
            "logits_rel_diff": diff, "max_abs_logit": top,
            "fault_logits_rel_diff": {m: rel(m) for m in _cursor_faults(cfg)},
            "attention": attn}


def phase_vlm_serve(dev, seed, cfg):
    """internvl2 FULL (every width; phase 30 cuts its depth), 2:8
    u4-packed layer by layer: VLM_ROWS prompts of stub-frontend prefix
    rows and text prefilled through lm_prefill_step, then 16 per-slot
    decode steps;
    exact nm_spmm launches (7 x L a forward), ms and tok/s, five decode
    steps under torch.profiler."""
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.train import step as ST

    sp = SparsityConfig(n=2, m=8, method="bdwp")
    torch.cuda.reset_peak_memory_stats()
    store, compact, variants, pack_s = pack_full(dev, seed, cfg, sp)
    b, text, prefix = VLM_ROWS
    gen = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (b, text), generator=gen, device=dev)
    emb = torch.randn((b, prefix, cfg.d_model), generator=gen,
                      device=dev).to(torch.bfloat16)
    steps, prof_steps = 16, 5
    with torch.no_grad():
        K.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = ST.lm_prefill_step(
            store.params, {"tokens": toks, "prefix_embeds": emb}, cfg=cfg,
            sp_cfg=sp, last_index=[prefix + text - 1] * b)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        pre_launches = K.launches
        s_tot = prefix + text
        cache = _grow_cache(cfg, cache, s_tot + steps + prof_steps + 1, dev)
        tok = torch.argmax(logits[:, -1, :cfg.vocab], -1)[:, None]
        pos = torch.full((b,), s_tot, device=dev)
        K.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = ST.lm_decode_step(store.params, cache, tok, pos,
                                              cfg=cfg, sp_cfg=sp)
            tok = torch.argmax(logits[:, -1, :cfg.vocab], -1)[:, None]
            pos = pos + 1
        torch.cuda.synchronize()
        decode_ms = 1e3 * (time.perf_counter() - t0) / steps
        dec_launches = K.launches
        state = {"tok": tok, "pos": pos, "cache": cache}

        def one():
            lg, state["cache"] = ST.lm_decode_step(
                store.params, state["cache"], state["tok"], state["pos"],
                cfg=cfg, sp_cfg=sp)
            state["tok"] = torch.argmax(lg[:, -1, :cfg.vocab], -1)[:, None]
            state["pos"] = state["pos"] + 1

        prof = profile_steps(one, prof_steps, ("nm_spmm",))
    peak = torch.cuda.max_memory_allocated()
    want = 7 * cfg.n_layers
    print(f"  {b} prompts of {prefix} prefix rows + {text} tokens: prefill "
          f"{prefill_ms:.1f} ms ({b * s_tot / prefill_ms * 1e3:.0f} tok/s), "
          f"nm_spmm launches {pre_launches} (want {want}); {steps} decode "
          f"steps {decode_ms:.2f} ms/step ({b * 1e3 / decode_ms:.1f} tok/s), "
          f"launches {dec_launches} (want {want * steps}); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    check(pre_launches == want and dec_launches == want * steps,
          "vlm serve: nm_spmm launch count")
    check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          "vlm serve: non-finite logits")
    check(peak < 80e9, "vlm serve: peak memory over 80 GB")
    return {"launches": pre_launches + dec_launches, "compact_launches":
            compact, "compact_variants": variants, "pack_s": pack_s,
            "prefill_ms": prefill_ms, "ms_per_step": decode_ms,
            "tok_per_s": b * 1e3 / decode_ms, "max_memory_allocated": peak,
            "hbm_report": store.report(), "profile": prof}


def phase_arch_serve(dev, seed, arch_id):
    """``arch_id``'s FULL config (its depth cut to ARCH_SERVE_LAYERS where
    it names one) served from 2:8 u4-packed weights: an arch with a
    stub-frontend prefix (internvl2) through lm_prefill_step with its
    1024-row prefix; one with a window (gemma3) through phase 6's engine
    run with prompts past the window, then the shared-cursor decode; the
    others (qwen2.5, glm4) through phase 6's engine run."""
    from repro_torch.configs import get_arch
    from repro_torch.core.sparsity import SparsityConfig

    cfg = arch_module(arch_id).FULL
    if arch_id in ARCH_SERVE_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=ARCH_SERVE_LAYERS[arch_id])
    if get_arch(arch_id).prefix_len:
        return phase_vlm_serve(dev, seed, cfg)
    if cfg.window is None:
        return phase_serve(dev, seed, cfg)
    sp = SparsityConfig(n=2, m=8, method="bdwp")
    return phase_serve(dev, seed, cfg, **GEMMA_LONG, then=lambda store, pr:
                       _shared_cursor_run(dev, cfg, sp, store, pr))


# -- phases 31-34: granite-moe-1b-a400m -------------------------------------

MOE_ARCH = "granite-moe-1b-a400m"
MOE_TRAIN_ROWS = (4, 1024)      # 8 routing groups of 512, capacity 160
# phase 31's stacked nm_spmm cases: (label, E, rows an expert, K, F):
# the TRAIN step's 1280 rows an expert (8 groups x capacity 160) for
# w_gate/w_up and w_down, and decode-like rows
MOE_SPMM = [("w_gate/w_up", 32, 1280, 1024, 512),
            ("w_down", 32, 1280, 512, 1024),
            ("w_gate/w_up B=8", 32, 8, 1024, 512),
            ("w_down B=8", 32, 8, 512, 1024)]
# phase 32, card vs CPU at SMOKE (both run the port, so XLA's rounding
# order, which sets the CPU tests' limits against the reference, plays no
# part): the forward's logits and aux and the decode's logits (read on an
# H100: 7.2e-7, 2.4e-7, 4.8e-7)
MOE_SMALL_ATOL = 1e-4
# the three pre-generated packed steps' (loss, aux, total), any step (read:
# 1.8e-5, 5.1e-4, 2.3e-5); the legacy steps keep SMALL_LOSS_ATOL, a limit
# per step: their routing flips moved the loss by 1.7e-2
MOE_PACKED_STEP_ATOL = (1e-3, 5e-3, 1e-3)
# phase 34's requests: phase 6's prompts asking for about half as many
# tokens (each decode step re-masks the experts: ~160 ms a step)
MOE_SERVE_NEW = (4, 12, 8, 6, 10, 5)
# phases 33-34 run granite at every width and this depth (of 24 layers),
# to keep the whole run in its time
MOE_LAYERS = 6


def stacked_case(gen, e, b, k, f, dev):
    """(act (E, B, K), vals (E, Kc, F), u8 idx, the dense bf16 stack)."""
    from repro_torch.core import sparsity as S

    w = torch.randn((e, k, f), generator=gen, device=dev).to(torch.bfloat16)
    vals, idx = S.nm_pack(w, 2, 8, axis=1)
    act = torch.randn((e, b, k), generator=gen, device=dev).to(
        torch.bfloat16)
    return act, vals, idx, S.nm_unpack_n(vals, idx, 2, 8, axis=1)


def moe_layer_views(cfg):
    """One granite layer's 7 fused_update sites as the optimizer views
    them: the 4 attention (K, F) masters and the 3 expert stacks'
    (E*K, F) views."""
    e, d, dff = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    attn = [(k, f) for name, k, f in arch_proj(cfg)[:4]]
    return attn + [(e * d, dff), (e * d, dff), (e * dff, d)]


def stacked_kernel_checks(dev, gen, cases, label):
    """nm_spmm on expert stacks in one launch, u8, at ``cases`` [(case,
    E, rows an expert, K, F)]: within the phase-3 tolerance of the plain
    version, each expert bitwise a 2-D launch on that expert, row 0
    bitwise the B = 1 result, deterministic; times (CUDA graph replay,
    cold L2) of the stacked launch, E separate 2-D launches, torch.bmm
    on the dense bf16 stacks and the plain version, against the bound.
    Returns (rows, max abs err)."""
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels import ref

    rows, worst = [], 0.0
    for case, e, b, k, f in cases:
        act, vals, idx, dense = stacked_case(gen, e, b, k, f, dev)
        kern = K.nm_spmm(act, vals, idx, 2, 8, 8)
        again = K.nm_spmm(act, vals, idx, 2, 8, 8)
        row0 = K.nm_spmm(act[:, :1].contiguous(), vals, idx, 2, 8, 8)
        plain = ref.ref_nm_spmm(act, vals, idx, 2, 8, 8)
        scale = torch.bmm(act.float().abs(), dense.float().abs())
        err = (kern - plain).abs()
        check(float((err - TOL * scale).max()) <= 0,
              f"{label} stacked nm_spmm {case}: error above tolerance")
        check(torch.equal(kern, again), f"{label} stacked nm_spmm {case}: "
              "not deterministic")
        check(torch.equal(kern[:, :1], row0), f"{label} stacked nm_spmm "
              f"{case}: row 0 depends on the batch")
        for j in range(e):
            check(torch.equal(kern[j], K.nm_spmm(act[j], vals[j], idx[j], 2,
                                                 8, 8)),
                  f"{label} stacked nm_spmm {case}: expert {j} != its 2-D "
                  "launch")
        worst = max(worst, float(err.max()))
        del plain, scale, err, kern, again, row0
        weight_bytes = vals.numel() * 3
        copies = max(2, -(-2 * L2_BYTES // weight_bytes))
        sets = [(vals, idx, dense)] + [stacked_case(gen, e, b, k, f, dev)[1:]
                                       for _ in range(copies - 1)]
        t_k = time_ms(lambda i: K.nm_spmm(act, sets[i][0], sets[i][1], 2, 8,
                                          8), copies, iters=10)
        t_s = time_ms(lambda i: [K.nm_spmm(act[j], sets[i][0][j],
                                           sets[i][1][j], 2, 8, 8)
                                 for j in range(e)], copies, iters=3)
        t_l = time_ms(lambda i: torch.bmm(act, sets[i][2]), copies, iters=10)
        t_p = time_ms(lambda i: ref.ref_nm_spmm(act, sets[i][0], sets[i][1],
                                                2, 8, 8), copies, iters=2)
        moved = (act.numel() * 2 + vals.numel() * 3 + e * b * f * 4)
        ops = 2 * e * b * vals.shape[1] * f
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
        t_b = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        pl = K.plan(b, k, f, 2, 8, e)
        rows.append({"case": case, "E": e, "B": b, "K": k, "F": f,
                     "ms": t_k, "separate_ms": t_s, "library_ms": t_l,
                     "plain_ms": t_p, "bound_ms": t_b, "bound_by": by,
                     "config": pl.config, "splits": pl.splits,
                     "dense_work_ms": 2 * e * b * k * f / BF16_OPS_PER_S
                     * 1e3})
        print(f"  E={e} B={b:4d} {case:16s} {k:4d}x{f:<4d} stacked "
              f"{t_k:.4f} ms, {e} 2-D launches {t_s:.4f} ms, torch.bmm "
              f"(dense bf16) {t_l:.4f} ms, bound {t_b:.4f} ms ({by}), plain "
              f"{t_p:.3f} ms; config {pl.config}, split-K {pl.splits}")
        del sets, act, vals, idx, dense
        torch.cuda.empty_cache()
    print(f"  {label} stacked nm_spmm: within tolerance, every expert "
          f"bitwise its 2-D launch, rows independent of B; max abs err "
          f"{worst:.3e}")
    return rows, worst


def layer_update_check(gen, views, dev, label):
    """One layer's sites, the (K, F) ``views``, in one grouped
    fused_update launch: bitwise the plain version (in place too), then
    timed against its byte bound (21.75 B/element) and the plain
    version.  Returns (max abs err, the timing row)."""
    from repro_torch.kernels import fused_update as KF
    from repro_torch.kernels import ref

    upd_err = grouped_update_check(gen, views, dev, UPDATE_SCALARS,
                                   f"{label} layer")
    torch.cuda.empty_cache()
    s = UPDATE_SCALARS
    layer = [update_case(gen, k, f, dev) for k, f in views]
    args = (s["lr"], s["mu"], s["wd"], s["lam"], 2, 8)
    t_g = time_ms(lambda i: KF.fused_update_sites(layer, *args, "bdwp"), 1,
                  iters=5)
    t_p = time_ms(lambda i: [ref.ref_fused_update(
        *site, n=2, m=8, axis=0, bp_mode="bdwp", **s) for site in layer], 1,
        iters=1)
    t_b = sum(update_bound_ms(k, f, 2, 8) for k, f in views)
    elems = sum(k * f for k, f in views)
    upd = {"sites": len(views), "views": views, "elements": elems,
           "ms": t_g, "plain_ms": t_p, "bound_ms": t_b, "bound_by": "bytes",
           "library_ms": None}
    print(f"  one {label} layer's {len(views)} sites ({elems} elements) in "
          f"one grouped fused_update launch: bitwise the plain version (in "
          f"place too); {t_g:.4f} ms against a {t_b:.4f} ms bound (21.75 "
          f"B/element; bound/kernel {t_b / t_g:.2f}), plain {t_p:.2f} ms")
    del layer
    torch.cuda.empty_cache()
    return upd_err, upd


def phase_moe_kernels(dev, gen):
    """nm_spmm on granite's expert stacks in one launch
    (``stacked_kernel_checks``); then one layer's 7 sites (4 attention,
    3 (E*K, F) expert views) in one grouped fused_update launch, bitwise
    the plain version, timed against its byte bound; then the four
    attention projections through ``proj_kernel_checks`` at decode rows
    and the TRAIN step's rows, as phase 27 holds the dense archs'."""
    from repro_torch.configs import get_arch

    rows, worst = stacked_kernel_checks(dev, gen, MOE_SPMM, "granite")
    cfg = get_arch(MOE_ARCH).full
    upd_err, upd = layer_update_check(gen, moe_layer_views(cfg), dev,
                                      "granite")
    attn_rows, attn_err = proj_kernel_checks(
        dev, gen, "granite", arch_proj(cfg)[:4],
        MOE_TRAIN_ROWS[0] * MOE_TRAIN_ROWS[1])
    print("  granite attention: nm_spmm within tolerance, rows independent "
          "of B; nm_compact of the 4 weights bitwise (u4, vector and "
          "scalar)")
    return worst, rows, upd_err, upd, attn_rows, attn_err


def phase_moe_small(dev, seed, arch_id=MOE_ARCH, small_atol=MOE_SMALL_ATOL,
                    step_atol=MOE_PACKED_STEP_ATOL, cursor=False):
    """An MoE arch's SMOKE (granite's unless ``arch_id`` names another),
    card vs CPU: forward logits and aux (bf16 weights); the routing
    tables given the same probabilities, bitwise; three BDWP steps,
    pre-generated and packed, and three legacy steps: loss, aux, total;
    prefill and 20 decode steps from u4-packed attention (masked
    experts), per slot and, with ``cursor``, with the shared cursor.
    ``small_atol`` holds the forward, aux and decode, ``step_atol`` the
    packed steps' (loss, aux, total): one limit a metric, or a (step,
    metric) table."""
    from repro_torch.configs import get_arch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.synthetic import lm_stream
    from repro_torch.models import moe as M
    from repro_torch.models import transformer_lm as T
    from repro_torch.optim import sgd
    from repro_torch.serve.packed_params import pack_tree_element
    from repro_torch.train import step as ST

    cfg = get_arch(arch_id).smoke
    name = arch_id.split("-")[0]
    sp = SparsityConfig(n=2, m=8, method="bdwp")
    opt = sgd.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
    params = T.init(cfg, seed=seed, device="cpu")
    streams = {d: lm_stream(cfg.vocab, 2, 32, device=d, seed=seed)
               for d in ("cpu", dev)}
    batch0 = {d: next(streams[d])[1] for d in streams}
    out = {}
    with torch.no_grad():
        for d in streams:
            p16 = sgd.tree_map(lambda _, t: t.to(d, torch.bfloat16), params)
            h, _, aux = T.forward(p16, batch0[d]["tokens"], cfg, sp)
            out[d] = (T.logits_from_hidden(p16, h, cfg), aux)
    d_fwd = float((out[dev][0].cpu() - out["cpu"][0]).abs().max())
    d_aux = abs(float(out[dev][1]) - float(out["cpu"][1]))
    print(f"  {name} SMOKE: forward |dlogit| {d_fwd:.3e}, |daux| "
          f"{d_aux:.3e} (tol {small_atol})")
    check(d_fwd <= small_atol, f"{name} small: forward logits disagree")
    check(d_aux <= small_atol, f"{name} small: aux disagrees")
    # the routing tables of the CPU's layer-0 probabilities, on both
    xt = torch.randn((4, 16, cfg.d_model),
                     generator=torch.Generator().manual_seed(seed)).to(
                         torch.bfloat16)
    w = params["blocks"][0]["moe"]["router"]["w"]
    probs = M.router_probs(xt, w)
    r_cpu, r_dev = M.route(probs, cfg.moe), M.route(probs.to(dev), cfg.moe)
    for field in ("gate_idx", "gates", "pos", "keep", "slot_token"):
        check(bits_equal(getattr(r_cpu, field),
                         getattr(r_dev, field).cpu()),
              f"{name} small: routing {field} differs between card and "
              "CPU")
    probs_dev = M.router_probs(xt.to(dev), w.to(dev))
    d_probs = float((probs_dev.cpu() - probs).abs().max())
    losses = {}
    for flow, pregen in (("pregen packed", True), ("legacy", False)):
        states = {d: ST.train_state_from_params(
            sgd.tree_map(lambda _, t: t.to(d, copy=True), params), sp,
            pregen=pregen, pregen_pack=pregen) for d in streams}
        if pregen:
            check(_compute_bitwise(states["cpu"]["compute"],
                                   states[dev]["compute"]),
                  f"{name} small: step-0 compute trees differ")
        data = {d: lm_stream(cfg.vocab, 2, 32, device=d, seed=seed)
                for d in streams}
        hist = {d: [] for d in streams}
        for _ in range(3):
            for d in streams:
                _, batch = next(data[d])
                states[d], met = ST.lm_train_step(
                    states[d], batch, cfg=cfg, sp_cfg=sp, opt_cfg=opt,
                    pregen=pregen, pregen_pack=pregen)
                hist[d].append([float(met[k])
                                for k in ("loss", "aux", "total")])
        diffs = np.abs(np.array(hist[dev]) - np.array(hist["cpu"]))
        print(f"  {flow}: |d| loss/aux/total " + "; ".join(
            " ".join(f"{x:.2e}" for x in step) for step in diffs.tolist()))
        check(np.all(np.isfinite(hist[dev])), f"{name} small {flow}: "
              "non-finite metrics")
        tol = (np.broadcast_to(np.asarray(step_atol), (3, 3)) if pregen
               else np.array(SMALL_LOSS_ATOL)[:, None])
        check(np.all(diffs <= tol),
              f"{name} small {flow}: loss, aux or total disagree")
        losses[flow] = (hist[dev], diffs.tolist(),
                        step_atol if pregen else SMALL_LOSS_ATOL)
    packed = {d: pack_tree_element(
        sgd.tree_map(lambda _, t: t.to(torch.bfloat16), params), sp,
        device=d)[0] for d in streams}
    d_dec = _small_decode(dev, seed, cfg, sp, packed, 0, True)
    d_cur = (_small_decode(dev, seed, cfg, sp, packed, 0, False) if cursor
             else None)
    print(f"  prefill + {ARCH_DECODE_STEPS} decode steps, card vs CPU: per "
          f"slot |dlogit| {d_dec:.3e}"
          + (f", shared cursor {d_cur:.3e}" if cursor else ""))
    check(d_dec <= small_atol, f"{name} small: decode logits disagree")
    check(d_cur is None or d_cur <= small_atol,
          f"{name} small: shared-cursor decode logits disagree")
    print(f"  {name} SMOKE: forward |dlogit| {d_fwd:.3e} (tol "
          f"{small_atol}), |daux| {d_aux:.3e}; router probabilities "
          f"|d| {d_probs:.3e}, routing tables of the same probabilities "
          "bitwise; step-0 compute trees bitwise")
    for flow, (h, diffs, tol) in losses.items():
        print(f"  {flow}: loss/aux/total card " + "; ".join(
            " ".join(f"{x:.5f}" for x in step) for step in h)
              + " |d| " + "; ".join(" ".join(f"{x:.2e}" for x in step)
                                    for step in diffs)
              + f" (tol {tol} per "
              + ("step" if tol is SMALL_LOSS_ATOL
                 or np.ndim(tol) == 2 else "metric") + ")")
    print(f"  prefill + {ARCH_DECODE_STEPS} decode steps per slot"
          + (" and with the shared cursor" if cursor else "") + ", u4 "
          f"attention, masked experts: |dlogit| {d_dec:.3e}"
          + (f", {d_cur:.3e}" if cursor else "") + f" (tol {small_atol})")
    return {"forward": d_fwd, "aux": d_aux, "decode": d_dec,
            "decode_shared_cursor": d_cur, "losses": losses}


def _expert_mask_ms(store, cfg, sp):
    """Device ms of the experts' FF mask derivation in one decode step:
    every layer's three bf16 stacks (and shared experts) re-masked along
    K, as ``MaskedOp`` does on each call."""
    from repro_torch.core import operand as O

    stacks = [b["moe"][n] for b in store.params["blocks"]
              for n in ("w_gate", "w_up", "w_down")]
    stacks += [b["moe"]["shared"][n] for b in store.params["blocks"]
               if "shared" in b["moe"] for n in ("w_gate", "w_up", "w_down")]
    return time_ms(lambda i: [O._ff_weights(w, sp) for w in stacks], 1,
                   iters=2)


def phase_moe_serve(dev, seed, cfg=None, lens=SERVE_LENS, new=MOE_SERVE_NEW):
    """An MoE FULL config (granite's 24 layers unless ``cfg`` names
    another) through phase 6's engine run: attention (and a prelude)
    packed 2:8 u4 (4 x 24 nm_compact a pack, 4 x 24 nm_spmm an engine
    step for granite), the expert stacks and shared experts bf16 and
    masked on every call, as the reference serves them; then the
    experts' mask derivation's share of a decode step."""
    from repro_torch.configs import granite_moe_1b
    from repro_torch.core.sparsity import SparsityConfig

    cfg = cfg or granite_moe_1b.FULL
    sp = SparsityConfig(n=2, m=8, method="bdwp")

    def masks(store, _):
        ms = _expert_mask_ms(store, cfg, sp)
        shared = (f" and {cfg.moe.n_shared} shared experts of {cfg.d_model} "
                  f"x {cfg.moe.n_shared * cfg.moe.d_expert}"
                  if cfg.moe.n_shared else "")
        print(f"  the experts' FF mask derivation (3 x {cfg.n_blocks} "
              f"stacks of {cfg.moe.n_experts} x {cfg.d_model} x "
              f"{cfg.moe.d_expert}{shared}, on every call): {ms:.3f} ms of "
              "device time a decode step")
        return {"expert_mask_ms": ms}

    out = phase_serve(dev, seed, cfg, lens=lens, new=new, then=masks)
    share = out["then"]["expert_mask_ms"] / out["ms_per_step"]
    print(f"  mask derivation: {share:.3f} of an engine step's "
          f"{out['ms_per_step']:.2f} ms")
    out["then"]["share_of_step"] = share
    return out


# -- phases 35-38: deepseek-v2-lite-16b -------------------------------------

DS_ARCH = "deepseek-v2-lite-16b"
DS_TRAIN_ROWS = (4, 1024)       # 8 routing groups of 512, capacity 60
# phase 35's stacked nm_spmm cases (label, E, rows an expert, K, F): the
# TRAIN step's 480 rows an expert (8 groups x capacity 60)
DS_SPMM = [("w_gate/w_up", 64, 480, 2048, 1408),
           ("w_down", 64, 480, 1408, 2048)]
# phase 36, card vs CPU at SMOKE: the forward, aux and decode at
# granite's limit (read on an H100: 7.2e-7, 2.4e-7); the packed steps'
# (loss, aux, total) a step: steps 0-1 read <= 4.8e-7, step 2 (the first
# after an update at lr 0.05) 2.5e-3 / 3.2e-2 / 2.8e-3, a routing or
# selection flip of the ulp-apart updated weights, as granite's legacy
# step 2 (1.7e-2)
DS_SMALL_ATOL = MOE_SMALL_ATOL
DS_PACKED_STEP_ATOL = ((1e-4, 1e-4, 1e-4), (1e-4, 1e-4, 1e-4),
                       (1e-2, 5e-2, 1e-2))
# phase 38's requests: 4 prompts (every slot busy) asking for few tokens:
# each forward re-masks 14.8 G expert weights
DS_SERVE_LENS, DS_SERVE_NEW = (5, 32, 17, 9), (2, 4, 3, 2)
# phase 38's depth: every published width, the prelude and 8 of the 26
# MoE layers (the whole run's time: every forward re-masks the experts)
DS_SERVE_LAYERS = 5


def ds_proj(cfg):
    """deepseek's distinct 2-D weight shapes (name, K, F): the five MLA
    projections, the prelude's FFN and the shared experts."""
    h, d = cfg.n_heads, cfg.d_model
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    ff, sh = cfg.first_dense_ff, cfg.moe.n_shared * cfg.moe.d_expert
    return [("q_proj", d, h * (dn + dr)), ("kv_down", d, cfg.kv_lora + dr),
            ("k_up", cfg.kv_lora, h * dn), ("v_up", cfg.kv_lora, h * dv),
            ("o_proj", h * dv, d), ("prelude w_gate/w_up", d, ff),
            ("prelude w_down", ff, d), ("shared w_gate/w_up", d, sh),
            ("shared w_down", sh, d)]


def ds_layer_views(cfg):
    """One deepseek MoE layer's 11 fused_update sites as the optimizer
    views them: the 5 MLA (K, F) masters, the 3 expert stacks' (E*K, F)
    views and the 3 shared-expert matrices."""
    e, d, dff = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    proj = {name: (k, f) for name, k, f in ds_proj(cfg)}
    attn = [proj[n] for n in ("q_proj", "kv_down", "k_up", "v_up", "o_proj")]
    shared = [proj["shared w_gate/w_up"]] * 2 + [proj["shared w_down"]]
    return attn + [(e * d, dff), (e * d, dff), (e * dff, d)] + shared


def ds_pack_timing(dev, gen, cfg):
    """``pack_timing`` at deepseek's element pack: its six weight shapes
    (the prelude's q_proj, kv_down, o_proj and FFN; every MoE layer's
    q_proj, kv_down and o_proj), 84 weights."""
    proj = {name: (k, f) for name, k, f in ds_proj(cfg)}
    # weights of each shape in one pack: the attention three in every
    # layer, the prelude's FFN once (w_gate and w_up)
    shapes = [("q_proj", *proj["q_proj"], cfg.n_layers),
              ("kv_down", *proj["kv_down"], cfg.n_layers),
              ("o_proj", *proj["o_proj"], cfg.n_layers),
              ("prelude w_gate/w_up", *proj["prelude w_gate/w_up"], 2),
              ("prelude w_down", *proj["prelude w_down"], 1)]
    return pack_timing(dev, gen, shapes, "the deepseek")


def phase_deepseek_kernels(dev, gen):
    """deepseek's shapes through the ported kernels: the 64-expert stacks
    in one stacked nm_spmm launch at the TRAIN step's 480 rows an expert
    (``stacked_kernel_checks``); one MoE layer's 11 sites in one grouped
    fused_update launch (``layer_update_check``); the 2-D shapes (MLA,
    the prelude's FFN, the shared experts) through
    ``proj_kernel_checks`` at decode rows (u4) and the TRAIN step's 4096
    rows (u8), and nm_compact of each (vector and scalar) bitwise: the
    element pack's 84 weights take six of these shapes."""
    from repro_torch.configs import get_arch

    cfg = get_arch(DS_ARCH).full
    rows, worst = stacked_kernel_checks(dev, gen, DS_SPMM, "deepseek")
    upd_err, upd = layer_update_check(gen, ds_layer_views(cfg), dev,
                                      "deepseek")
    proj_rows, proj_err = proj_kernel_checks(
        dev, gen, "deepseek", ds_proj(cfg),
        DS_TRAIN_ROWS[0] * DS_TRAIN_ROWS[1])
    print(f"  deepseek 2-D shapes: nm_spmm within tolerance, rows "
          f"independent of B; nm_compact of the {len(ds_proj(cfg))} shapes "
          "bitwise (u4, vector and scalar)")
    pack_rows, pack = ds_pack_timing(dev, gen, cfg)
    return worst, rows, upd_err, upd, proj_rows, proj_err, pack_rows, pack


# -- phases 39-42: mamba2-370m and hymba-1.5b (SSM and hybrid layers) ------

SSM_ARCHS = ("mamba2-370m", "hymba-1.5b")
# the TRAIN step of both: 4 x 2048 tokens, so hymba's training attention
# runs banded past its 1024 window and the SSD scan passes its state
# across 16 chunks of 128
SSM_TRAIN_ROWS = (4, 2048)
# phase 40, card vs CPU at SMOKE: the SSM state and conv window after a
# prefill (fp32, from bf16 inputs an ulp apart now and then); the padded
# prefill's logits against the unpadded one's on the card (another
# sequence length: cuBLAS's head product may sum otherwise)
SSM_STATE_ATOL = 2e-3
SSM_PREFILL_ATOL = 1e-4         # prefill vs the forward, on one side
SSM_HAZARD = dict(prompt=5, bucket=16)
# phases 41-42 run mamba2 and hymba at every width and this depth (of
# 48 / 32 layers), to pay for phases 43-46 in the run's time
SSM_LAYERS = {"mamba2-370m": 6, "hymba-1.5b": 4}


def ssm_proj(cfg):
    """The 2-D weight sites (name, K, F) of one layer of an SSM or hybrid
    config: the attention and FFN projections, then the SSD block's
    (in_proj only where it is a site)."""
    sc = cfg.ssm_cfg()
    shape = {"in_proj": (cfg.d_model, sc.d_in_proj),
             "out_proj": (sc.d_inner, cfg.d_model)}
    attn = arch_proj(cfg) if cfg.has_attn else []
    return attn + [(name, *shape[name]) for _, name in ssm_site_paths(cfg)]


def pack_timing(dev, gen, shapes, label):
    """nm_compact (vector variant, u4) at the element pack's weight
    ``shapes`` [(name, K, F, weights of that shape in a pack)], timed
    with cold L2 beside the plain version and the byte bound, and the
    whole pack summed from them.  Returns (rows, totals)."""
    from repro_torch.kernels import ref

    rows = []
    for name, k, f, count in shapes:
        copies = max(2, -(-2 * L2_BYTES // (k * f * 2)))
        ws = [torch.randn((k, f), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(copies)]
        t_k = time_ms(lambda i: compact_view(ws[i].t(), 2, 8, 4, "vector"),
                      copies)
        t_p = time_ms(lambda i: ref.ref_nm_compact(ws[i].t(), 2, 8, 4),
                      copies, iters=3)
        t_b = compact_bound_ms(f, k, 2, 8, 4, 2)
        rows.append({"proj": name, "K": k, "F": f, "count": count,
                     "ms": t_k, "plain_ms": t_p, "bound_ms": t_b,
                     "bound_by": "bytes", "library_ms": None})
        print(f"  pack {name:19s} {k:5d}x{f:<5d} bf16 u4 vector {t_k:.4f} "
              f"ms, bound {t_b:.4f} ms (bytes), plain {t_p:.4f} ms; "
              f"{count} in a pack")
        del ws
    tot = {key: sum(r[key] * r["count"] for r in rows)
           for key in ("ms", "plain_ms", "bound_ms")}
    print(f"  {label} FULL element pack's {sum(r['count'] for r in rows)} "
          f"weights: {tot['ms']:.3f} ms of nm_compact = "
          f"{tot['bound_ms'] / tot['ms']:.2f} of its {tot['bound_ms']:.3f} ms "
          f"bound; plain {tot['plain_ms']:.2f} ms")
    return rows, tot


def phase_ssm_kernels(dev, gen):
    """mamba2's and hymba's sites through the ported kernels: nm_spmm at
    decode rows (B = 4, u4) and the TRAIN step's 8192 rows (u8) within
    the phase-3 tolerance, row 0 bitwise the B = 1 result, timed beside
    dense torch.matmul (``proj_kernel_checks``; mamba2's in_proj F = 4384
    is 34 whole 128-column tiles and one of 32), and its plain version's
    time at both; one layer's sites in one grouped
    fused_update launch, bitwise the per-site plain calls, timed against
    21.75 B/element (``layer_update_check``); nm_compact of each weight
    (vector and scalar) bitwise, and the FULL element pack's launches
    timed shape by shape (``pack_timing``).  Returns {arch: rows} and the
    worst errors."""
    from repro_torch.configs import get_arch

    out, worst = {}, {"nm_spmm": 0.0, "fused_update": 0.0}
    b_train = SSM_TRAIN_ROWS[0] * SSM_TRAIN_ROWS[1]
    for arch_id in SSM_ARCHS:
        cfg = get_arch(arch_id).full
        proj = ssm_proj(cfg)
        rows, err = proj_kernel_checks(dev, gen, arch_id, proj, b_train)
        worst["nm_spmm"] = max(worst["nm_spmm"], err)
        upd_err, upd = layer_update_check(gen, [(k, f) for _, k, f in proj],
                                          dev, arch_id)
        worst["fused_update"] = max(worst["fused_update"], upd_err)
        torch.cuda.empty_cache()
        pack_rows, pack = pack_timing(
            dev, gen, [(name, k, f, cfg.n_layers * (2 if name == "w_gate"
                                                    else 1))
                       for name, k, f in proj if name != "w_up"], arch_id)
        plain = sum(r["plain_ms"] for r in rows if r["B"] == b_train)
        print(f"  {arch_id}: nm_spmm within tolerance at its {len(proj)} "
              f"sites, rows independent of B, plain version {plain:.3f} ms "
              f"for a layer's sites at {b_train} rows; one grouped "
              "fused_update over the layer's sites bitwise (in place too); "
              "nm_compact of each weight bitwise (u4, vector and scalar)")
        out[arch_id] = {"spmm": rows, "update": upd, "pack_rows": pack_rows,
                        "pack": pack}
        torch.cuda.empty_cache()
    return worst, out


def _ssm_hazard(dev, cfg, params, sp):
    """The reference hazard on ``dev``: a prompt of SSM_HAZARD["prompt"]
    tokens prefilled alone and right-padded to SSM_HAZARD["bucket"], as
    the engine pads it: (|dlogit| of the two prefills, layer 0's state
    gap, the first decode step's |dlogit|)."""
    from repro_torch.train import step as ST

    n, bucket = SSM_HAZARD["prompt"], SSM_HAZARD["bucket"]
    prompt = torch.arange(1, n + 1, device=dev)[None] * 7 % cfg.vocab
    padded = torch.zeros((1, bucket), dtype=prompt.dtype, device=dev)
    padded[:, :n] = prompt
    out = []
    with torch.no_grad():
        for toks in (prompt, padded):
            lg, cache = ST.lm_prefill_step(params, {"tokens": toks}, cfg=cfg,
                                           sp_cfg=sp, last_index=[n - 1])
            state = cache["layers"][0]["state"].clone()
            cache = _grow_cache(cfg, cache, bucket + 2, dev)
            step, _ = ST.lm_decode_step(
                params, cache, prompt[:, -1:], torch.tensor([n], device=dev),
                cfg=cfg, sp_cfg=sp)
            out.append((lg, state, step))
    (l1, s1, d1), (l2, s2, d2) = out
    return (float((l1 - l2).abs().max()), float((s1 - s2).abs().max()),
            float((d1 - d2)[..., :cfg.vocab].abs().max()))


def phase_ssm_small(dev, seed):
    """mamba2 and hymba at SMOKE size, card vs CPU: forward logits;
    prefill with a cache (its logits, the fp32 SSM state and conv
    window; on each side the forward's last position's logits within
    SSM_PREFILL_ATOL); prefill
    and ARCH_DECODE_STEPS decode steps per slot and with the shared
    cursor from u4-packed weights (hymba's windowed attention past its
    16); the padded-prefill hazard on the card as on the CPU; three
    packed pre-generated BDWP steps (step-0 compute trees bitwise) and
    one legacy step."""
    from repro_torch.configs import get_arch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.synthetic import lm_stream
    from repro_torch.models import transformer_lm as T
    from repro_torch.optim import sgd
    from repro_torch.serve.packed_params import pack_tree_element
    from repro_torch.train import step as ST

    sp = SparsityConfig(n=2, m=8, method="bdwp")
    dense = SparsityConfig(n=2, m=8, method="dense")
    opt = sgd.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
    result = {}
    for arch_id in SSM_ARCHS:
        cfg = get_arch(arch_id).smoke
        name = arch_id.split("-")[0]
        params = T.init(cfg, seed=seed, device="cpu")
        devs = ("cpu", dev)
        batch0 = {d: next(lm_stream(cfg.vocab, 2, 32, device=d,
                                    seed=seed))[1] for d in devs}
        fwd, pre, p16 = {}, {}, {}
        with torch.no_grad():
            for d in devs:
                p16[d] = sgd.tree_map(lambda _, t: t.to(d, torch.bfloat16),
                                      params)
                h, _, _ = T.forward(p16[d], batch0[d]["tokens"], cfg, sp)
                fwd[d] = T.logits_from_hidden(p16[d], h, cfg)
                pre[d] = ST.lm_prefill_step(p16[d], {"tokens": batch0[d][
                    "tokens"]}, cfg=cfg, sp_cfg=sp)
        # the same hidden states; the head's product over 2 rows, not 64,
        # may sum in another order
        d_self = max(float((pre[d][0][:, 0] - fwd[d][:, -1]).abs().max())
                     for d in devs)
        check(d_self <= SSM_PREFILL_ATOL, f"{name} small: prefill logits != "
              "the forward's last position")
        d_fwd = float((fwd[dev].cpu() - fwd["cpu"]).abs().max())
        check(d_fwd <= SMALL_ATOL, f"{name} small: forward logits disagree")
        d_state = max(float((a["state"].cpu() - b["state"]).abs().max())
                      for a, b in zip(pre[dev][1]["layers"],
                                      pre["cpu"][1]["layers"]))
        d_conv = max(float((a["conv"].cpu() - b["conv"]).abs().max())
                     for a, b in zip(pre[dev][1]["layers"],
                                     pre["cpu"][1]["layers"]))
        check(max(d_state, d_conv) <= SSM_STATE_ATOL,
              f"{name} small: prefill SSM caches disagree")
        packed = {d: pack_tree_element(
            sgd.tree_map(lambda _, t: t.to(torch.bfloat16), params), sp,
            device=d)[0] for d in devs}
        dec = {}
        for mode in ("per_slot", "shared"):
            dec[mode] = _small_decode(dev, seed, cfg, sp, packed, 0,
                                      mode == "per_slot")
            check(dec[mode] <= SMALL_ATOL,
                  f"{name} small: {mode} decode logits disagree")
        hazard = {d: _ssm_hazard(d, cfg, p16[d], dense) for d in devs}
        for d, (d_pre, gap_state, gap_dec) in hazard.items():
            check(d_pre <= SMALL_ATOL and gap_state > 1e-2 and gap_dec > 1.0,
                  f"{name} small: the padded-prefill hazard is not "
                  f"reproduced on {d}")
        check(abs(hazard[dev][2] - hazard["cpu"][2]) <= 0.25,
              f"{name} small: the hazard's decode gaps disagree")
        losses = {}
        for flow, pregen, steps in (("pregen packed", True, 3),
                                    ("legacy", False, 1)):
            states = {d: ST.train_state_from_params(
                sgd.tree_map(lambda _, t: t.to(d, copy=True), params), sp,
                pregen=pregen, pregen_pack=pregen) for d in devs}
            if pregen:
                check(_compute_bitwise(states["cpu"]["compute"],
                                       states[dev]["compute"]),
                      f"{name} small: step-0 compute trees differ")
            data = {d: lm_stream(cfg.vocab, 2, 32, device=d, seed=seed)
                    for d in devs}
            hist = {d: [] for d in devs}
            for _ in range(steps):
                for d in devs:
                    _, batch = next(data[d])
                    states[d], met = ST.lm_train_step(
                        states[d], batch, cfg=cfg, sp_cfg=sp, opt_cfg=opt,
                        pregen=pregen, pregen_pack=pregen)
                    hist[d].append(float(met["loss"]))
            diffs = [abs(a - b) for a, b in zip(hist[dev], hist["cpu"])]
            check(all(math.isfinite(x) for x in hist[dev]),
                  f"{name} small {flow}: non-finite loss")
            check(all(x <= t for x, t in zip(diffs, SMALL_LOSS_ATOL)),
                  f"{name} small {flow}: losses disagree")
            losses[flow] = (hist[dev], diffs)
        print(f"  {name} SMOKE: forward |dlogit| {d_fwd:.3e} (tol "
              f"{SMALL_ATOL}); prefill vs the forward's last position "
              f"{d_self:.2e} (tol {SSM_PREFILL_ATOL}); prefill caches "
              f"|dstate| {d_state:.3e}, "
              f"|dconv| {d_conv:.3e} (tol {SSM_STATE_ATOL}); prefill + "
              f"{ARCH_DECODE_STEPS} decode steps per slot "
              f"{dec['per_slot']:.3e}, shared cursor {dec['shared']:.3e}")
        print(f"  {name} padded-prefill hazard (prefill |dlogit|, layer-0 "
              "state gap, first decode step's |dlogit|): card "
              + " ".join(f"{x:.3e}" for x in hazard[dev]) + ", CPU "
              + " ".join(f"{x:.3e}" for x in hazard["cpu"]))
        for flow, (h, diffs) in losses.items():
            print(f"  {name} {flow}: losses card "
                  + " ".join(f"{x:.5f}" for x in h) + " |d| "
                  + " ".join(f"{x:.2e}" for x in diffs)
                  + f" (tol {SMALL_LOSS_ATOL[:len(h)]})")
        result[arch_id] = {"forward": d_fwd, "state": d_state,
                           "conv": d_conv, "decode": dec,
                           "hazard": {"card": hazard[dev],
                                      "cpu": hazard["cpu"]},
                           "losses": losses}
    return result


WHISPER = "whisper-large-v3"
# the TRAIN step: 8 rows of 1500 frames (a 30-second segment) and 448
# target tokens (Whisper's own max_target; the config keeps 32768
# positions, as the reference's)
WHISPER_TRAIN_ROWS = (8, 1500, 448)
# phase 46: 4 rows, each with its own 1500 frames and the start-of-
# transcript prompt of whisper-large-v3's generation config
# (<|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>), the
# prefill cache seated in a WHISPER_MAX_LEN-long one, then
# WHISPER_DECODE_STEPS greedy steps on the shared cursor
WHISPER_SERVE_ROWS = 4
WHISPER_PROMPT = (50258, 50259, 50360, 50364)
WHISPER_MAX_LEN = 448
WHISPER_DECODE_STEPS = 32
WHISPER_B1_STEPS = 16           # phase 46's B = 1 against B = 4 steps
# phases 45-46: encoder + decoder layers (45: 4 + 24, 264
# sites, past the 256 of fused_update's by-value table; 46: 4 + 4)
WHISPER_TRAIN_LAYERS = (4, 24)
WHISPER_SERVE_LAYERS = 4
# phase 43's nm_spmm cases (label, B, K, F, idx bits): decode rows (u4),
# the TRAIN step's 12,000 encoder rows (u8), and a decode step's cross
# K/V projection over 4 rows x 1500 frames (u4)
WHISPER_SPMM = [
    ("q/k/v/o, xattn", 4, 1280, 1280, 4), ("ffn w_in", 4, 1280, 5120, 4),
    ("ffn w_out", 4, 5120, 1280, 4),
    ("q/k/v/o, xattn", 12000, 1280, 1280, 8),
    ("ffn w_in", 12000, 1280, 5120, 8), ("ffn w_out", 12000, 5120, 1280, 8),
    ("xattn k/v cross K/V", 6000, 1280, 1280, 4)]
# phase 44: the seated cache's decode after an 8-token prefill against
# a 9-token prefill (the same last position) must be this much closer
# than the unseated one's, on each side
WHISPER_HAZARD_RATIO = 4.0
# phase 44, card vs CPU at SMOKE: the encoder output and the logits (up
# to 3.7, where a bf16 ulp is 1.6e-2; measured 1.1e-2 to 2.1e-2 a step
# on the card, not growing over 20 decode steps); the CPU tests hold the
# compiled reference at the same
WHISPER_SMALL_ATOL = 4e-2
WHISPER_SMALL_TOKENS = 9


def whisper_site_views(cfg, stack):
    """The (K, F) weight sites of one encoder or decoder layer, in the
    tree's order: q/k/v/o (and a decoder's cross-attention q/k/v/o), FFN
    in and out."""
    d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
    attn = [(d, hd), (d, hd), (d, hd), (hd, d)]
    return (attn * (2 if stack == "dec_blocks" else 1)
            + [(d, cfg.d_ff), (cfg.d_ff, d)])


WHISPER_PATHS = {
    "enc_blocks": tuple(("attn", n) for n in ("q_proj", "k_proj", "v_proj",
                                              "o_proj"))
    + (("ffn", "w_in"), ("ffn", "w_out")),
    "dec_blocks": tuple((sub, n) for sub in ("attn", "xattn")
                        for n in ("q_proj", "k_proj", "v_proj", "o_proj"))
    + (("ffn", "w_in"), ("ffn", "w_out"))}


def whisper_launches(cfg):
    """(nm_spmm a TRAIN step, sites a step, nm_spmm a prefill, nm_spmm a
    decode step, those of them at the encoder's rows): every site's FF
    once in the forward and once in its block's recompute; a prefill
    runs every site once; a decode step the decoder's, its
    cross-attention k/v over the encoder output."""
    enc = len(WHISPER_PATHS["enc_blocks"]) * cfg.n_enc_layers
    dec = len(WHISPER_PATHS["dec_blocks"]) * cfg.n_layers
    return 2 * (enc + dec), enc + dec, enc + dec, dec, 2 * cfg.n_layers


def phase_whisper_kernels(dev, gen):
    """whisper-large-v3's shapes through the ported kernels: nm_spmm at
    WHISPER_SPMM (``spmm_case_checks``) and nm_compact of each weight
    shape bitwise (u4, vector and scalar); one decoder layer's 10 sites
    in one grouped fused_update launch, bitwise the per-site plain
    calls, timed against 21.75 B/element (``layer_update_check``); a
    grouped launch over 512 sites, past the by-value table, bitwise;
    the FULL element pack's 512 nm_compact launches timed shape by
    shape (``pack_timing``)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import fused_update as KF

    cfg = get_arch(WHISPER).full
    rows, spmm_err = spmm_case_checks(dev, gen, "whisper", WHISPER_SPMM)
    for k, f in {(1280, 1280), (1280, 5120), (5120, 1280)}:
        w = torch.randn((k, f), generator=gen, device=dev).to(torch.bfloat16)
        check_compact_view(w.t(), 2, 8, 4, ("vector", "scalar"),
                           f"whisper {k}x{f} u4")
        del w
    upd_err, upd = layer_update_check(
        gen, whisper_site_views(cfg, "dec_blocks"), dev, "whisper decoder")
    # as many sites as a whisper step, small: the table goes through
    # device memory (more than KF.PARAM_SITES)
    n_sites = whisper_launches(cfg)[1]
    many = [(64, 128 + 64 * (i % 3)) for i in range(n_sites)]
    check(n_sites > KF.PARAM_SITES, "whisper: the step fits a by-value "
          "fused_update table")
    upd_err = max(upd_err, grouped_update_check(
        gen, many, dev, UPDATE_SCALARS, f"{n_sites} small sites"))
    print(f"  one grouped fused_update launch over {n_sites} small sites "
          f"(a table of more than {KF.PARAM_SITES} in device memory): "
          "bitwise the plain version (in place too)")
    torch.cuda.empty_cache()
    counts = collections.Counter(
        (k, f) for stack, n in (("enc_blocks", cfg.n_enc_layers),
                                ("dec_blocks", cfg.n_layers))
        for k, f in whisper_site_views(cfg, stack) * n)
    pack_rows, pack = pack_timing(
        dev, gen, [(f"{k}x{f}", k, f, c) for (k, f), c in counts.items()],
        WHISPER)
    print(f"  whisper: nm_spmm within tolerance at its {len(rows)} cases, "
          "rows independent of B; nm_compact of each weight shape bitwise")
    return {"nm_spmm": spmm_err, "fused_update": upd_err}, {
        "spmm": rows, "update": upd, "pack_rows": pack_rows, "pack": pack}


def _encdec_seat(cfg, cache, max_len, dev):
    """A prefill cache copied into a ``max_len``-long one (its positions
    first, the cursors kept), as every driver of the reference's
    encoder-decoder must before it decodes."""
    from repro_torch.models import encdec as E

    b = cache["layers"][0]["k"].shape[0]
    out = E.init_cache(cfg, b, max_len, device=dev)
    for dst, src in zip(out["layers"], cache["layers"]):
        s = src["k"].shape[1]
        dst["k"][:, :s] = src["k"]
        dst["v"][:, :s] = src["v"]
        dst["pos"] = src["pos"]
    return out


def _whisper_hazard(dev, cfg, params, sp, frames, toks):
    """The reference hazard on ``dev``: the last of n tokens' logits
    from one n-token prefill against an (n-1)-token prefill and one
    decode step, its cache seated in an n-long one and unseated: (the
    seated gap, the unseated gap)."""
    from repro_torch.train import step as ST

    n = toks.shape[1]
    with torch.no_grad():
        full, _, _ = ST.encdec_prefill_step(
            params, {"frames": frames, "tokens": toks}, cfg=cfg, sp_cfg=sp)
        gaps = []
        for seat in (True, False):
            _, cache, enc = ST.encdec_prefill_step(
                params, {"frames": frames, "tokens": toks[:, :-1]}, cfg=cfg,
                sp_cfg=sp)
            if seat:
                cache = _encdec_seat(cfg, cache, n, dev)
            step, _ = ST.encdec_decode_step(params, cache, enc,
                                            toks[:, -1:], n - 1, cfg=cfg,
                                            sp_cfg=sp)
            gaps.append(float((step - full)[..., :cfg.vocab].abs().max()))
    return tuple(gaps)


def phase_whisper_small(dev, seed):
    """whisper SMOKE, card vs CPU: the encoder output and the logits;
    the prefill with a cache against the forward's last position (on
    each side) and against the other side; a 9-token prefill's cache
    seated and ARCH_DECODE_STEPS shared-cursor decode steps from
    u4-packed weights, teacher-forced by the CPU's argmax; the reference
    hazard (an unseated prefill cache decodes over its last position) on
    both sides; three packed pre-generated steps (step-0 compute trees
    bitwise) and one legacy step."""
    from repro_torch.configs import get_arch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.synthetic import encdec_stream
    from repro_torch.models import encdec as E
    from repro_torch.optim import sgd
    from repro_torch.serve.packed_params import pack_tree_element
    from repro_torch.train import step as ST

    cfg = get_arch(WHISPER).smoke
    sp = SparsityConfig(n=2, m=8, method="bdwp")
    dense = SparsityConfig(n=2, m=8, method="dense")
    opt = sgd.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
    params = E.init(cfg, seed=seed, device="cpu")
    devs = ("cpu", dev)
    n_tok = WHISPER_SMALL_TOKENS
    batch0 = {d: next(encdec_stream(cfg.vocab, 2, n_tok, cfg.d_model,
                                    enc_frames=32, device=d, seed=seed))[1]
              for d in devs}
    enc, fwd, pre, p16 = {}, {}, {}, {}
    with torch.no_grad():
        for d in devs:
            p16[d] = sgd.tree_map(lambda _, t: t.to(d, torch.bfloat16),
                                  params)
            b = batch0[d]
            enc[d] = E.encode(p16[d], b["frames"], cfg, sp)
            h, _ = E.decode(p16[d], b["tokens"], enc[d], cfg, sp)
            fwd[d] = E.logits_from_hidden(p16[d], h, cfg)
            pre[d] = ST.encdec_prefill_step(p16[d], b, cfg=cfg, sp_cfg=sp)
    d_self = max(float((pre[d][0][:, 0] - fwd[d][:, -1]).abs().max())
                 for d in devs)
    check(d_self <= SSM_PREFILL_ATOL, "whisper small: prefill logits != the "
          "forward's last position")
    d_enc = float((enc[dev].cpu().float() - enc["cpu"].float()).abs().max())
    d_fwd = float((fwd[dev].cpu() - fwd["cpu"]).abs().max())
    d_pre = float((pre[dev][0].cpu() - pre["cpu"][0]).abs().max())
    check(max(d_enc, d_fwd, d_pre) <= WHISPER_SMALL_ATOL,
          "whisper small: encoder output or logits disagree")
    # packed serving: prefill 8 tokens, seat, decode teacher-forced
    packed = {d: pack_tree_element(
        sgd.tree_map(lambda _, t: t.to(torch.bfloat16), params), sp,
        device=d)[0] for d in devs}
    logits, caches, encs, gaps = {}, {}, {}, []
    with torch.no_grad():
        for d in devs:
            b = batch0[d]
            logits[d], cache, encs[d] = ST.encdec_prefill_step(
                packed[d], {"frames": b["frames"],
                            "tokens": b["tokens"][:, :8]}, cfg=cfg, sp_cfg=sp)
            caches[d] = _encdec_seat(cfg, cache, 8 + ARCH_DECODE_STEPS, d)
        for step in range(ARCH_DECODE_STEPS + 1):
            gaps.append(float((logits[dev].cpu() - logits["cpu"])[
                ..., :cfg.vocab].abs().max()))
            if step == ARCH_DECODE_STEPS:
                break
            tok = torch.argmax(logits["cpu"][:, -1, :cfg.vocab], -1)[:, None]
            for d in devs:
                logits[d], caches[d] = ST.encdec_decode_step(
                    packed[d], caches[d], encs[d], tok.to(d), 8 + step,
                    cfg=cfg, sp_cfg=sp)
    d_dec = max(gaps)
    print("  whisper SMOKE packed prefill, then decode steps: card vs CPU "
          "|dlogit| " + " ".join(f"{x:.2e}" for x in gaps))
    check(d_dec <= WHISPER_SMALL_ATOL,
          "whisper small: packed decode logits disagree")
    hazard = {d: _whisper_hazard(d, cfg, sgd.tree_map(
        lambda _, t: t.to(d, torch.bfloat16), params), dense,
        batch0[d]["frames"], batch0[d]["tokens"]) for d in devs}
    for d, (seated, unseated) in hazard.items():
        check(unseated >= WHISPER_HAZARD_RATIO * seated,
              f"whisper small: the unseated prefill cache's hazard is not "
              f"reproduced on {d}")
    check(abs(hazard[dev][1] - hazard["cpu"][1]) <= 0.1,
          "whisper small: the hazard's gaps disagree")
    losses = {}
    for flow, pregen, steps in (("pregen packed", True, 3),
                                ("legacy", False, 1)):
        states = {d: ST.train_state_from_params(
            sgd.tree_map(lambda _, t: t.to(d, copy=True), params), sp,
            pregen=pregen, pregen_pack=pregen) for d in devs}
        if pregen:
            check(_compute_bitwise(states["cpu"]["compute"],
                                   states[dev]["compute"]),
                  "whisper small: step-0 compute trees differ")
        data = {d: encdec_stream(cfg.vocab, 2, 16, cfg.d_model,
                                 enc_frames=32, device=d, seed=seed)
                for d in devs}
        hist = {d: [] for d in devs}
        for _ in range(steps):
            for d in devs:
                _, batch = next(data[d])
                states[d], met = ST.encdec_train_step(
                    states[d], batch, cfg=cfg, sp_cfg=sp, opt_cfg=opt,
                    pregen=pregen, pregen_pack=pregen)
                hist[d].append(float(met["loss"]))
        diffs = [abs(a - b) for a, b in zip(hist[dev], hist["cpu"])]
        check(all(math.isfinite(x) for x in hist[dev]),
              f"whisper small {flow}: non-finite loss")
        check(all(x <= t for x, t in zip(diffs, SMALL_LOSS_ATOL)),
              f"whisper small {flow}: losses disagree")
        losses[flow] = (hist[dev], diffs)
    print(f"  whisper SMOKE: encoder |d| {d_enc:.3e}, forward |dlogit| "
          f"{d_fwd:.3e}, prefill {d_pre:.3e} (tol {WHISPER_SMALL_ATOL}); "
          "prefill vs "
          f"the forward's last position {d_self:.2e} (tol "
          f"{SSM_PREFILL_ATOL}); packed prefill + {ARCH_DECODE_STEPS} "
          f"shared-cursor decode steps from a seated cache {d_dec:.3e}")
    print("  whisper unseated-cache hazard (seated gap, unseated gap): card "
          + " ".join(f"{x:.3e}" for x in hazard[dev]) + ", CPU "
          + " ".join(f"{x:.3e}" for x in hazard["cpu"]))
    for flow, (h, diffs) in losses.items():
        print(f"  whisper {flow}: losses card "
              + " ".join(f"{x:.5f}" for x in h) + " |d| "
              + " ".join(f"{x:.2e}" for x in diffs)
              + f" (tol {SMALL_LOSS_ATOL[:len(h)]})")
    return {"encoder": d_enc, "forward": d_fwd, "prefill": d_pre,
            "decode": d_dec, "hazard": {"card": hazard[dev],
                                        "cpu": hazard["cpu"]},
            "losses": losses}


def phase_whisper_train(dev, seed, cfg=None, rows=None):
    """whisper TRAIN (FULL: every width, 32 + 32 layers), BDWP 2:8 packed
    pre-generation, ``rows`` = (rows, frames, tokens): five timed steps
    with exact launch counts, a profiled sixth (the encdec/* ranges), the
    operands of each stack's first and last layer equal to the pack of
    the new master, peak."""
    import functools

    from repro_torch.configs import whisper_large_v3 as W
    from repro_torch.core import sparsity as S
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.synthetic import encdec_stream
    from repro_torch.kernels import fused_update as KF
    from repro_torch.kernels import nm_spmm as KS
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST

    cfg, sp = cfg or W.TRAIN, SparsityConfig(n=2, m=8, method="bdwp")
    n_rows, frames, n_tok = rows or WHISPER_TRAIN_ROWS
    opt = sgd.SGDConfig(lr=0.004, warmup_steps=2, total_steps=100)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = ST.init_train_state(cfg, sp, seed=seed, device=dev)
    torch.cuda.synchronize()
    print(f"  init {cfg.n_enc_layers} + {cfg.n_layers} layers + "
          f"pre-generation: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    step_fn = functools.partial(ST.encdec_train_step, cfg=cfg, sp_cfg=sp,
                                opt_cfg=opt)
    data = encdec_stream(cfg.vocab, n_rows, n_tok, cfg.d_model,
                         enc_frames=frames, device=dev, seed=seed)
    spmm, sites = whisper_launches(cfg)[:2]
    want = (spmm, 1, sites)
    KS.launches = KF.launches = KF.launched_sites = 0
    losses, times, per_step = [], [], []
    for _ in range(5):
        _, batch = next(data)
        c0 = (KS.launches, KF.launches, KF.launched_sites)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        per_step.append(tuple(a - b for a, b in zip(
            (KS.launches, KF.launches, KF.launched_sites), c0)))
        print(f"  step {len(losses) - 1}: loss {loss:.6f} lr "
              f"{float(met['lr']):.4g} {times[-1]:.1f} ms "
              f"({n_rows * n_tok / times[-1] * 1e3:.0f} decoder tok/s); "
              f"launches nm_spmm {per_step[-1][0]} (want {want[0]}), "
              f"fused_update {per_step[-1][1]} over {per_step[-1][2]} sites "
              f"(want {want[1]} over {want[2]})")
        check(math.isfinite(loss), "whisper train: non-finite loss")
        check(per_step[-1] == want, "whisper train: launch counts")
    launches = {"nm_spmm": KS.launches, "fused_update": KF.launches,
                "fused_update_sites": KF.launched_sites}
    _, batch = next(data)
    state, met, prof = profile_train_step(step_fn, state, batch)
    check(math.isfinite(float(met["loss"])), "whisper train: non-finite loss")
    check(prof["argmax_kernels"] == 0,
          "whisper train: an argmax reduce (a plain N:M selection) is left")
    peak = torch.cuda.max_memory_allocated()
    site_elems = 0
    for stack, n in (("enc_blocks", cfg.n_enc_layers),
                     ("dec_blocks", cfg.n_layers)):
        site_elems += n * sum(k * f for k, f in whisper_site_views(cfg,
                                                                   stack))
        for i in (0, n - 1):
            for path in WHISPER_PATHS[stack]:
                name = f"{stack}[{i}]/" + "/".join(path)
                op = _at(state["compute"], (stack, i, *path, "w"))
                w = _at(state["master"], (stack, i, *path, "w"))
                vals, idx = S.nm_pack(w, 2, 8, axis=0)
                check(torch.equal(op.vals.view(torch.int16),
                                  vals.to(torch.bfloat16).view(torch.int16))
                      and torch.equal(op.idx, idx),
                      f"whisper train: {name} packed operand != "
                      "nm_pack(master)")
                check(torch.equal(op.mask, S.nm_mask(w, 2, 8, axis=0)),
                      f"whisper train: {name} stored mask != nm_mask(master)")
                bp = torch.where(S.nm_mask(w, 2, 8, axis=1), w, 0.0)
                check(bits_equal(op.bp, bp.to(torch.bfloat16)),
                      f"whisper train: {name} bp != the BP-axis mask's "
                      "operand")
                del vals, idx, bp
    print("  both stacks' first and last layers: packed vals/idx == "
          "nm_pack(new master), stored mask == nm_mask(new master), bp == "
          "bf16(where(nm_mask(new master, BP axis), master, 0)); the step's "
          f"grouped launch covers {site_elems} elements")
    steady = sorted(times[1:])
    ms = steady[len(steady) // 2]
    tokens = n_rows * n_tok
    print(f"  {cfg.name} {cfg.n_enc_layers} + {cfg.n_layers} layers, "
          f"{n_rows} x ({frames} frames, {n_tok} tokens): median of steps "
          f"1-4 {ms:.1f} ms/step, {tokens / ms * 1e3:.0f} decoder tokens/s, "
          f"{n_rows * frames / ms * 1e3:.0f} frames/s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    check(peak < 80e9, f"train {cfg.name}: peak memory over 80 GB")
    return {"losses": losses, "step_ms": times, "ms_per_step": ms,
            "tokens_per_s": tokens / ms * 1e3, "launches": launches,
            "launches_per_step": per_step, "max_memory_allocated": peak,
            "site_elements": site_elems, "profile": prof}


def _whisper_greedy(params, cfg, sp, frames, prompt, dev, steps=None):
    """Prefill ``prompt`` (B, P) after ``frames``, seat the cache in a
    WHISPER_MAX_LEN-long one, then ``steps`` (WHISPER_DECODE_STEPS)
    greedy steps on the shared cursor: (tokens (B, steps + 1), prefill
    ms, decode ms a step)."""
    from repro_torch.train import step as ST

    steps = WHISPER_DECODE_STEPS if steps is None else steps

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, enc = ST.encdec_prefill_step(
            params, {"frames": frames, "tokens": prompt}, cfg=cfg, sp_cfg=sp)
        cache = _encdec_seat(cfg, cache, WHISPER_MAX_LEN, dev)
        tok = torch.argmax(logits[:, -1, :cfg.vocab], -1)[:, None]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = [tok]
        for step in range(steps):
            logits, cache = ST.encdec_decode_step(
                params, cache, enc, tok, prompt.shape[1] + step, cfg=cfg,
                sp_cfg=sp)
            tok = torch.argmax(logits[:, -1, :cfg.vocab], -1)[:, None]
            out.append(tok)
        toks = torch.cat(out, 1).cpu()
        t2 = time.perf_counter()
    return toks, 1e3 * (t1 - t0), 1e3 * (t2 - t1) / steps


def _whisper_logits(params, cfg, sp, frames, prompt, dev):
    """Greedy prefill and WHISPER_B1_STEPS decode steps: (the logits of
    each, decode ms a step)."""
    from repro_torch.train import step as ST

    with torch.no_grad():
        logits, cache, enc = ST.encdec_prefill_step(
            params, {"frames": frames, "tokens": prompt}, cfg=cfg, sp_cfg=sp)
        cache = _encdec_seat(cfg, cache, WHISPER_MAX_LEN, dev)
        out = [logits]
        tok = torch.argmax(logits[:, -1, :cfg.vocab], -1)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(WHISPER_B1_STEPS):
            logits, cache = ST.encdec_decode_step(
                params, cache, enc, tok, prompt.shape[1] + step, cfg=cfg,
                sp_cfg=sp)
            out.append(logits)
            tok = torch.argmax(logits[:, -1, :cfg.vocab], -1)[:, None]
        torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0) / WHISPER_B1_STEPS


def phase_whisper_serve(dev, seed, cfg=None):
    """whisper FULL from 2:8 u4 element-packed weights (512 nm_compact,
    all vector): WHISPER_SERVE_ROWS rows of their own 1500 frames and
    the start prompt, prefilled (512 nm_spmm), the cache seated, then
    WHISPER_DECODE_STEPS greedy shared-cursor decode steps (320 nm_spmm a
    step, 64 of them the cross K/V at the encoder's rows); each row's
    tokens equal its solo run's (the row alone among idle slots); five
    decode steps under the profiler (idle share; the cross K/V's device
    time replayed alone, and its range's host time)."""
    from repro_torch.configs import whisper_large_v3 as W
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import nm_compact as KC
    from repro_torch.kernels import nm_spmm as KS
    from repro_torch.models import encdec as E
    from repro_torch.serve.packed_params import PackedParamStore
    from repro_torch.train import step as ST

    cfg, sp = cfg or W.FULL, SparsityConfig(n=2, m=8, method="bdwp")
    _, _, per_prefill, per_decode, cross = whisper_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = E.init(cfg, seed=seed, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    KC.launches = 0
    KC.variant_launches.update(dict.fromkeys(KC.VARIANTS, 0))
    t0 = time.perf_counter()
    store = PackedParamStore.pack(params, sp, idx_bits=4, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    del params
    compact, variants = KC.launches, dict(KC.variant_launches)
    print(f"  init {init_s:.1f} s + pack {pack_s:.4f} s ({cfg.n_enc_layers} "
          f"+ {cfg.n_layers} layers, nm_compact launches {compact}, want "
          f"{per_prefill}, by variant {variants}); n_packed "
          f"{store.n_packed}, n_dense {store.n_dense}")
    check(compact == per_prefill, "whisper serve: nm_compact launch count")
    check(variants["vector"] == compact, "whisper serve: an element-pack "
          "launch missed the vector variant")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = WHISPER_SERVE_ROWS
    frames = torch.randn((b, cfg.max_source, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    prompt = torch.tensor([WHISPER_PROMPT] * b, device=dev)
    params = store.params
    _whisper_greedy(params, cfg, sp, frames[:1], prompt[:1], dev, steps=1)
    KS.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        ST.encdec_prefill_step(params, {"frames": frames, "tokens": prompt},
                               cfg=cfg, sp_cfg=sp)
    prefill_launches = KS.launches
    check(prefill_launches == per_prefill, "whisper serve: nm_spmm "
          "launches a prefill")
    toks, prefill_ms, decode_ms = _whisper_greedy(params, cfg, sp, frames,
                                                  prompt, dev)
    batched = KS.launches
    decode_launches = (batched - 2 * per_prefill) / WHISPER_DECODE_STEPS
    check(decode_launches == per_decode, "whisper serve: nm_spmm launches a "
          "decode step")
    tok_s = b * (WHISPER_DECODE_STEPS + 1) / ((prefill_ms + decode_ms
                                               * WHISPER_DECODE_STEPS) / 1e3)
    print(f"  batched: {b} rows x ({cfg.max_source} frames, "
          f"{len(WHISPER_PROMPT)}-token prompt), prefill {prefill_ms:.1f} ms "
          f"(nm_spmm {prefill_launches}, want {per_prefill}), "
          f"{WHISPER_DECODE_STEPS} decode steps {decode_ms:.2f} ms/step "
          f"(nm_spmm {decode_launches:.0f} a step, want {per_decode}, "
          f"{cross} of them the cross K/V at {b * cfg.max_source} rows), "
          f"{tok_s:.1f} tok/s")
    # a row's solo run: the row alone in its slot, the other slots' frames
    # zero, as the engine's solo runs hold a request among idle slots (a
    # batch of another size may sum the norms' rows in another order)
    for i in range(b):
        alone = torch.zeros_like(frames)
        alone[i] = frames[i]
        solo, _, _ = _whisper_greedy(params, cfg, sp, alone, prompt, dev)
        check(torch.equal(solo[i], toks[i]),
              f"whisper serve: row {i}'s tokens != its solo run's")
    print(f"  all {b} rows' tokens equal their solo runs' (each alone in "
          f"its slot, the others' frames zero; {WHISPER_DECODE_STEPS + 1} "
          "tokens each)")
    # B = 1 against B = 4: the serving steps run the decoder under
    # layers.batch_invariant (the attention and the LayerNorms at a batch
    # padded to 8 rows); without it row 0 parts
    from repro_torch.models import layers as L

    on = L.batch_invariant
    cost, parted = {}, None
    for label, ctx in (("invariant", on), ("plain", contextlib.nullcontext),
                       ("plain", contextlib.nullcontext),
                       ("invariant", on)):
        L.batch_invariant = ctx
        try:
            four, ms4 = _whisper_logits(params, cfg, sp, frames, prompt, dev)
            one, ms1 = _whisper_logits(params, cfg, sp, frames[:1],
                                       prompt[:1], dev)
        finally:
            L.batch_invariant = on
        same = sum(bool(torch.equal(x[:1], y)) for x, y in zip(four, one))
        gap = max(float((x[:1] - y)[..., :cfg.vocab].abs().max())
                  for x, y in zip(four, one))
        cost.setdefault(label, []).append((ms4, ms1))
        if label == "invariant":
            check(same == len(four), f"whisper serve: row 0 decoded alone "
                  f"(B = 1) parts from B = 4 at {len(four) - same} of "
                  f"{len(four)} steps (largest gap {gap:.3e})")
        else:
            parted = (same, len(four), gap)
    med = {k: [sorted(v[j] for v in runs)[len(runs) // 2]
               for j in range(2)] for k, runs in cost.items()}
    print(f"  B = 1 against B = 4, row 0: logits bitwise at all "
          f"{len(four)} steps (prefill + {len(four) - 1} decode); without "
          f"batch_invariant bitwise at {parted[0]} of {parted[1]}, largest "
          f"gap {parted[2]:.3e}; decode ms a step with / without it: B = 4 "
          f"{med['invariant'][0]:.2f} / {med['plain'][0]:.2f}, B = 1 "
          f"{med['invariant'][1]:.2f} / {med['plain'][1]:.2f}")
    with torch.no_grad():
        _, cache, enc = ST.encdec_prefill_step(
            params, {"frames": frames, "tokens": prompt}, cfg=cfg, sp_cfg=sp)
        cache = _encdec_seat(cfg, cache, WHISPER_MAX_LEN, dev)
        pos = [len(WHISPER_PROMPT)]
        tok = prompt[:, -1:]

        def step():
            ST.encdec_decode_step(params, cache, enc, tok, pos[0], cfg=cfg,
                                  sp_cfg=sp)
            pos[0] += 1

        prof = profile_steps(step, 5, ("nm_spmm",))
        # the profiler links no ctypes launch (nm_spmm) to its range, so
        # the cross K/V's device time is that of a decode step's 32
        # layers of _enc_kv replayed alone; its host time is the range's
        cross_kv = time_ms(lambda i: [E._enc_kv(bp, enc, cfg, sp)
                                      for bp in params["dec_blocks"]], 1,
                           iters=2)
    host_kv = prof["parts"].get("encdec/cross_kv", {}).get("host_ms", 0.0)
    print(f"  encdec/cross_kv: {cross_kv:.3f} device ms a decode step (the "
          f"{cfg.n_layers} layers' k/v projections replayed alone), "
          f"{cross_kv / prof['device_busy_ms_per_step']:.3f} of the step's "
          f"busy time; host {host_kv:.2f} ms a step in its range, "
          f"{host_kv / prof['wall_ms_per_step']:.3f} of the profiled wall")
    peak = torch.cuda.max_memory_allocated()
    report = store.report()
    print(f"  max_memory_allocated {peak / 2**30:.2f} GiB")
    print("  hbm_report " + json.dumps(report))
    check(peak < 80e9, "whisper serve: peak memory over 80 GB")
    return {"launches": KS.launches, "prefill_launches": prefill_launches,
            "decode_launches": decode_launches, "compact_launches": compact,
            "compact_variants": variants, "pack_s": pack_s,
            "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "tok_per_s": tok_s, "cross_kv_device_ms": cross_kv,
            "cross_kv_host_ms": host_kv, "batched_launches": batched,
            "tokens": toks.tolist(), "max_memory_allocated": peak,
            "hbm_report": report, "profile": prof,
            "b1_vs_b4_without_invariance": parted,
            "decode_ms_invariant_vs_plain": med}


# ---------------------------------------------------------------------------
# Phases 47-50: the compressed sync on the new archs, mvue, the process form
# ---------------------------------------------------------------------------

# phase 47's leaves: (arch, the leaf's name in tree_map's terms, the
# gradient's dtype): the unit the sync launches at, from the FULL config's
# plan (a layer stack of ragged leaves is one unit of L x 50 elements)
SYNC_NEW_LEAVES = [
    ("granite-moe-1b-a400m", "blocks/moe/w_gate", "bf16"),
    ("deepseek-v2-lite-16b", "blocks/moe/w_gate", "bf16"),
    ("deepseek-v2-lite-16b", "prelude/ffn/w_gate/w", "bf16"),
    ("mamba2-370m", "blocks/ssm/in_proj/w", "bf16"),
    ("mamba2-370m", "blocks/ssm/conv_w", "fp32"),
    ("mamba2-370m", "blocks/ssm/A_log", "fp32"),
    ("hymba-1.5b", "blocks/ssm/conv_w", "fp32"),
    ("hymba-1.5b", "blocks/ssm/A_log", "fp32"),
    ("hymba-1.5b", "blocks/ssm/in_proj/w", "fp32")]
SYNC_PLAIN_MAX = 1 << 25          # plain versions timed up to this numel
MVUE_DRAWS = 4096                 # phase 48's draws of one gradient
SYNC_MOE_LAYERS = 6               # phases 49-50: granite at 6 of 24 layers
SYNC_MOE_STEPS = 5
SYNC_PROC_STEPS = 3
SYNC_LR = 0.1                     # the launcher's default


def _unit_names(tree, plan):
    """{leaf name: (members, column, numel)} of each unit of ``plan``,
    named after its first member (the first layer's, for a block list)."""
    from repro_torch.optim import sgd

    names = []
    sgd.tree_map(lambda name, _: names.append(name), tree)
    out = {}
    for members, col, numel in plan.units:
        out.setdefault(names[members[0]], (members, col, numel))
    return out


def phase_sync_new_leaves(dev, gen):
    """grad_compress and grad_decompress_mean at the new archs' leaves as
    the sync launches them ((2, numel) gradient rows, the residual's
    columns): both variants bitwise against the plain versions and the EF
    identity (``_check_sync_case``), the vector variant timed against the
    byte bound and the plain version; then hymba FULL's SSD leaves of all
    32 layers (the A_log, D and dt_bias stacks one unit each) through
    cross_pod_sync on the card against the CPU, bitwise."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import grad_compress as K
    from repro_torch.kernels import ref
    from repro_torch.optim import compress as CS
    from repro_torch.optim import sgd

    worst, rows = 0.0, []
    for arch, name, dt in SYNC_NEW_LEAVES:
        tree, _ = _sync_shapes(get_arch(arch).full)
        units = _unit_names(tree, CS.plan_for(tree, 1 << 16, 8))
        members, _, numel = units[name]
        label = f"{arch} {name} ({2}, {numel})" + (
            f" [{len(members)} layers in one unit]" if len(members) > 1
            else "")
        g, err = sync_case(gen, 2, numel, 8, dt, False, dev)
        # the vector variant wants the payload's rows on 16 bytes
        variants = (("vector", "scalar") if numel % 32 == 0
                    else ("auto", "scalar"))
        w, _ = _check_sync_case(K, ref, label, g, err, 2, 8, variants)
        worst = max(worst, w)
        vals, idx, _ = K.grad_compress(g, _copy_view(err), 2, 8)
        out = torch.empty(numel, dtype=g.dtype, device=dev)
        iters = 5 if numel > 1 << 26 else 20
        t_c = time_ms(lambda i: K.grad_compress(g, err, 2, 8, out_err=err),
                      1, iters=iters)
        t_m = time_ms(lambda i: K.grad_decompress_mean(vals, idx, 2, 8,
                                                       out=out), 1,
                      iters=iters)
        p_c = p_m = None
        if numel <= SYNC_PLAIN_MAX:
            p_c = time_ms(lambda i: ref.ref_grad_compress(g, err, 2, 8), 1,
                          iters=2)
            p_m = time_ms(lambda i: out.copy_(ref.ref_grad_decompress_mean(
                vals, idx, 2, 8)), 1, iters=2)
        gbytes = g.element_size()
        b_c = compress_bound_ms(2, numel, 2, 8, gbytes)
        b_m = mean_bound_ms(2, numel, 2, 8, gbytes)
        rows.append({"arch": arch, "leaf": name, "dtype": dt, "P": 2,
                     "K": numel, "layers_in_unit": len(members),
                     "grad_compress": {"ms": t_c, "plain_ms": p_c,
                                       "bound_ms": b_c},
                     "grad_decompress_mean": {"ms": t_m, "plain_ms": p_m,
                                              "bound_ms": b_m}})
        plain = (f"; plain {p_c:.4f} / {p_m:.4f} ms" if p_c is not None
                 else "; plain not timed at this size")
        print(f"  {label} {dt}: bitwise ({' and '.join(variants)}); "
              "grad_compress "
              f"{t_c:.4f} ms (bound {b_c:.4f}: {b_c / t_c:.0%}), "
              f"grad_decompress_mean {t_m:.4f} ms (bound {b_m:.4f}: "
              f"{b_m / t_m:.0%}){plain}")
        del g, err, vals, idx, out
        torch.cuda.empty_cache()
    # hymba FULL's SSD leaves through the sync, card against CPU
    cfg = get_arch("hymba-1.5b").full
    ssm = cfg.ssm_cfg()
    cpu_gen = torch.Generator().manual_seed(47)
    grads = {"blocks": [{"ssm": {
        "conv_w": torch.randn((2, ssm.d_conv, ssm.conv_dim),
                              generator=cpu_gen),
        **{k: torch.randn((2, ssm.n_heads), generator=cpu_gen)
           for k in ("A_log", "D", "dt_bias")}}}
        for _ in range(cfg.n_layers)]}
    gc = CS.GradCompressConfig()
    plan = CS.plan_for(grads, gc.bucket_elems, gc.m, stacked=True)
    err = torch.randn((2, plan.width), generator=cpu_gen) * 0.1
    # (each side its own copy: the sync updates the residual in place)
    on = {d: CS.cross_pod_sync(sgd.tree_map(lambda _, x: x.to(d), grads),
                               err.to(d, copy=True), gc)
          for d in ("cpu", dev)}
    torch.cuda.synchronize()
    same = all(bits_equal(a.cpu(), b) for a, b in zip(
        sgd.tree_leaves(on[dev][0]), sgd.tree_leaves(on["cpu"][0])))
    check(same and bits_equal(on[dev][1].cpu(), on["cpu"][1]),
          "hymba SSD leaves: card sync != CPU sync")
    print(f"  hymba FULL SSD leaves of {cfg.n_layers} layers: "
          f"{len(plan.units)} units ({len(plan.stacks)} layer stacks of "
          f"{cfg.n_layers} x {ssm.n_heads}), card sync == CPU sync, "
          "bitwise")
    return worst, rows


def phase_mvue(dev, seed):
    """mvue on the card: given the same uniforms the sync of a tree with
    a granite expert stack, a ragged leaf and a layer stack equals the
    CPU's bitwise and keeps the residual; the step-seeded draws repeat;
    over MVUE_DRAWS draws of one gradient the mean estimate is within 5
    standard errors; mvue_compress timed beside grad_compress."""
    from repro_torch.core.sparsity import nm_unpack_n
    from repro_torch.kernels import grad_compress as KG
    from repro_torch.optim import compress as CS
    from repro_torch.optim import sgd

    g = torch.Generator().manual_seed(seed + 48)
    grads = {"experts": (torch.randn((2, 32, 1024, 512), generator=g)
                         * 1e-2).to(torch.bfloat16),
             "norm": torch.randn((2, 1024), generator=g),
             "bias": torch.randn((2, 3), generator=g),
             "blocks": [{"x": torch.randn((2, 50), generator=g)}
                        for _ in range(32)]}
    cfg = CS.GradCompressConfig(estimator="mvue")
    plan = CS.plan_for(grads, cfg.bucket_elems, cfg.m, stacked=True)
    err = torch.randn((2, plan.width), generator=g)
    u = torch.rand((2, plan.width // cfg.m), generator=g)
    before = KG.launches["grad_decompress_mean"]
    out = {}
    for d in ("cpu", dev):
        e = err.to(d, copy=True)
        mean, e2 = CS.cross_pod_sync(sgd.tree_map(lambda _, x: x.to(d),
                                                  grads), e, cfg,
                                     uniforms=u.to(d))
        out[d] = ([x.cpu() for x in sgd.tree_leaves(mean)], e2.cpu())
    launched = KG.launches["grad_decompress_mean"] - before
    check(all(bits_equal(a, b) for a, b in zip(out[dev][0], out["cpu"][0])),
          "mvue: card sync != CPU sync given the same uniforms")
    check(bits_equal(out[dev][1], err), "mvue: the residual changed")
    check(launched == len(plan.units), f"mvue: {launched} "
          f"grad_decompress_mean launches, want {len(plan.units)}")
    dg = sgd.tree_map(lambda _, x: x.to(dev), grads)
    a = CS.cross_pod_sync(dg, err.to(dev), cfg, step=3)[0]
    b = CS.cross_pod_sync(dg, err.to(dev), cfg, step=3)[0]
    c = CS.cross_pod_sync(dg, err.to(dev), cfg, step=4)[0]
    check(all(bits_equal(x, y) for x, y in zip(sgd.tree_leaves(a),
                                                sgd.tree_leaves(b))),
          "mvue: the step's draws do not repeat")
    check(not bits_equal(a["experts"], c["experts"]),
          "mvue: two steps drew the same uniforms")
    print(f"  sync of {len(plan.units)} units (a (32, 1024, 512) bf16 "
          "expert stack, a 32-layer stack of (50,) leaves) and a ragged "
          f"leaf: card == CPU bitwise given the same uniforms, residual "
          f"kept, {launched} grad_decompress_mean launches; step-seeded "
          "draws repeat and differ by step")
    # unbiasedness: MVUE_DRAWS rows of one gradient
    t = (torch.randn((1, 8 * 4096), generator=g)
         * torch.exp(torch.randn((1, 8 * 4096), generator=g))).to(dev)
    rows = t.expand(MVUE_DRAWS, -1).contiguous()
    ud = torch.rand((MVUE_DRAWS, t.shape[1] // 8), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
    vals, idx = CS.mvue_compress(rows, 2, 8, ud)
    est = nm_unpack_n(vals.float(), idx, 2, 8).reshape(MVUE_DRAWS, -1)
    mean = est.mean(0)
    p = CS.mvue_probs(t.reshape(-1, 8).abs(), 2).reshape(-1)
    sigma = torch.where(p > 0, t[0].abs() * torch.sqrt(
        (1 - p) / torch.clamp(p, min=1e-30)), 0.0)
    often = (MVUE_DRAWS * p >= 25) | (p == 0)
    tol = 5 * sigma / MVUE_DRAWS ** 0.5 + 2.0 ** -8 * t[0].abs() + 1e-30
    worst = float(((mean - t[0]).abs() / tol)[often].max())
    kept = int((vals != 0).sum(-1).max())
    check(worst <= 1.0, "mvue: biased beyond 5 standard errors")
    print(f"  unbiasedness over {MVUE_DRAWS} draws of a (1, {t.shape[1]}) "
          f"gradient: |mean - g| / (5 se + bf16) at most {worst:.3f} over "
          f"the {float(often.float().mean()):.0%} of entries drawn 25 "
          f"times or more; at most {kept} nonzero slots of "
          f"{vals.shape[1]} a row")
    del rows, ud, vals, idx, est
    # mvue_compress beside grad_compress on the expert stack
    ge = dg["experts"].reshape(2, -1)
    ue = torch.rand((2, ge.shape[1] // 8), device=dev)
    ee = torch.zeros(ge.shape, dtype=torch.float32, device=dev)
    t_mvue = time_ms(lambda i: CS.mvue_compress(ge, 2, 8, ue), 1, iters=3)
    t_topk = time_ms(lambda i: KG.grad_compress(ge, ee, 2, 8, out_err=ee),
                     1, iters=20)
    print(f"  mvue_compress (plain PyTorch) on the (2, {ge.shape[1]}) bf16 "
          f"stack {t_mvue:.3f} ms; grad_compress (topk) {t_topk:.4f} ms")
    return {"units": len(plan.units), "decompress_launches": launched,
            "bias_worst": worst, "mvue_ms": t_mvue, "topk_ms": t_topk}


def _granite_sync_cfg():
    from repro_torch.configs import granite_moe_1b

    return dataclasses.replace(granite_moe_1b.FULL,
                               n_layers=SYNC_MOE_LAYERS)


def phase_train_granite_sync(dev, seed):
    """granite-moe-1b-a400m TRAIN (every width, SYNC_MOE_LAYERS layers),
    2 pods on one card, topk, BDWP 2:8 packed, the launcher's settings
    (lr 0.1, warmup 100, seed ``seed``, 4 x 1024 tokens): five timed
    steps with exact launch counts (grad_compress and
    grad_decompress_mean once per unit a step), the losses, the shared
    state's and each residual row's fingerprints after step 3 (phase 50
    holds the process form to them), a profiled sixth step (the sync's
    share), peak memory; under torch.use_deterministic_algorithms: the
    MoE backward accumulates the dispatch gather's gradient with atomics
    (index_select's backward), so two runs of one step part in the last
    bits without it (phase 50 runs the launcher with --deterministic)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _train_granite_sync(dev, seed)
    finally:
        torch.use_deterministic_algorithms(False)


def _train_granite_sync(dev, seed):
    import functools

    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.synthetic import lm_stream
    from repro_torch.kernels import fused_update as KF
    from repro_torch.kernels import grad_compress as KG
    from repro_torch.kernels import nm_spmm as KS
    from repro_torch.optim import compress as CS
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST
    from repro_torch.train.checkpoint import state_fingerprint

    cfg, sp = _granite_sync_cfg(), SparsityConfig(n=2, m=8, method="bdwp")
    opt = sgd.SGDConfig(lr=SYNC_LR, total_steps=SYNC_MOE_STEPS)
    gc = CS.GradCompressConfig.from_sparsity(sp)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = ST.init_train_state(cfg, sp, seed=seed, device=dev,
                                compress=True, n_pods=2)
    torch.cuda.synchronize()
    masters = {"init": [x.to("cpu", copy=True)
                        for x in sgd.tree_leaves(state["master"])]}
    plan = CS.plan_for(state["master"], gc.bucket_elems, gc.m)
    units = len(plan.units)
    print(f"  init {cfg.n_layers} layers + pre-generation + residual "
          f"{tuple(state['err'].shape)}: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; {units} units "
          "a sync")
    step_fn = functools.partial(ST.lm_train_step, cfg=cfg, sp_cfg=sp,
                                opt_cfg=opt, compress=True, n_pods=2,
                                grad_sync=gc)
    data = lm_stream(cfg.vocab, *MOE_TRAIN_ROWS, device=dev, seed=seed)
    tokens = MOE_TRAIN_ROWS[0] * MOE_TRAIN_ROWS[1]
    want = {"nm_spmm": 2 * 7 * cfg.n_layers * 2, "fused_update": 1,
            "fused_update_sites": 7 * cfg.n_layers, "grad_compress": units,
            "grad_decompress_mean": units}

    def counts():
        return {"nm_spmm": KS.launches, "fused_update": KF.launches,
                "fused_update_sites": KF.launched_sites, **KG.launches}

    KS.launches = KF.launches = KF.launched_sites = 0
    KG.launches.update(dict.fromkeys(KG.launches, 0))
    losses, times, prints = [], [], None
    for i in range(SYNC_MOE_STEPS):
        _, batch = next(data)
        c0 = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        got = {k: v - c0[k] for k, v in counts().items()}
        print(f"  step {i}: loss {loss!r} aux {float(met['aux']):.5f} "
              f"{times[-1]:.1f} ms; launches {got}")
        check(math.isfinite(loss), "granite sync: non-finite loss")
        check(got == want, f"granite sync: launches {got} != {want}")
        if i + 1 == SYNC_PROC_STEPS:   # each pod's rank of phase 50
            t1 = time.perf_counter()
            prints = {r: state_fingerprint(
                dict(state, err=state["err"][r:r + 1])) for r in range(2)}
            masters["after"] = [x.to("cpu", copy=True)
                                for x in sgd.tree_leaves(state["master"])]
            print(f"  fingerprints after step {i}: {prints} "
                  f"({time.perf_counter() - t1:.1f} s)")
    launches = counts()
    _, batch = next(data)
    state, met, prof = profile_train_step(step_fn, state, batch)
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(times[1:])
    ms = steady[len(steady) // 2]
    sync = prof["parts"].get("train/sync", {})
    share = sync.get("device_ms", 0.0) / max(prof["device_busy_ms"], 1e-9)
    print(f"  {cfg.name} x{cfg.n_layers} layers, 2 pods: median of steps "
          f"1-4 {ms:.1f} ms/step, {tokens / ms * 1e3:.0f} tokens/s; the "
          f"sync {sync.get('device_ms', 0.0):.2f} device ms ({share:.3f} of "
          f"busy), host {sync.get('host_ms', 0.0):.1f} ms; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    del state
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": times, "ms_per_step": ms,
            "tokens_per_s": tokens / ms * 1e3, "launches": launches,
            "units": units, "fingerprints": prints, "sync_share": share,
            "max_memory_allocated": peak, "profile": prof,
            "width": plan.width, "masters": masters}


def phase_train_granite_procs(dev, seed, one):
    """Phase 49's run in the process form: two processes on the one card,
    started through the launcher (``torchrun --standalone
    --nproc-per-node 2 -m repro_torch.launch.train ... --digest``: the
    mesh "pod=2", one pod a process), gloo between them,
    SYNC_PROC_STEPS steps: the losses and each rank's state (the shared
    state and its residual row) bitwise phase 49's after as many steps
    (fingerprints), the kernel launches of each rank, the backend, and
    the hop's gathers and bytes a step against ``wire_bytes``."""
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.models import transformer_lm as T
    from repro_torch.optim import compress as C
    from repro_torch.optim import sgd

    cfg, args = _mesh_cfg("granite-moe-1b-a400m", SYNC_MOE_LAYERS, dev)
    args += ["--steps", str(SYNC_PROC_STEPS), "--batch",
             str(MOE_TRAIN_ROWS[0]), "--seq", str(MOE_TRAIN_ROWS[1]),
             "--compress", "--lr", str(SYNC_LR), "--seed", str(seed),
             "--log-every", "1", "--digest", "--deterministic"]
    out, wall = launch_done(launch_mesh(dev, 2, args), "process form")
    lines = [ln for ln in out.splitlines() if ln.strip()]
    for ln in lines:
        if not ln.startswith("step "):
            print(f"  | {ln[:300]}")
    step_ms = [float(x) for x in re.findall(r"^step +\d+ loss \S+ "
                                            r"([\d.]+)ms$", out, re.M)]
    got = mesh_digest(out)
    backend = re.search(r"2 processes, backend (\w+) on (\S+)", out)
    sp = SparsityConfig(n=2, m=8, method="bdwp")
    plan = C.plan_for(T.abstract_params(cfg), 1 << 16, sp.m)
    total = sum(n for _, _, n in plan.units)
    ragged = sum(x.numel() for x, off in zip(
        sgd.tree_leaves(T.abstract_params(cfg)), plan.offsets) if off is None)
    wire = C.wire_bytes(total, ragged, C.GradCompressConfig.from_sparsity(sp))
    units = one["units"]
    want = {"nm_spmm": 2 * 7 * SYNC_MOE_LAYERS * SYNC_PROC_STEPS,
            "fused_update": SYNC_PROC_STEPS,
            "grad_compress": units * SYNC_PROC_STEPS,
            "grad_decompress_mean": units * SYNC_PROC_STEPS}
    ranks = {r: x["launches"] for r, x in got["ranks"].items()}
    check(got["losses"] == one["losses"][:SYNC_PROC_STEPS],
          f"process form: losses {got['losses']} != one card's "
          f"{one['losses'][:SYNC_PROC_STEPS]}")
    check(got["fingerprints"] == one["fingerprints"], f"process form: "
          f"state fingerprints {got['fingerprints']} != one card's "
          f"{one['fingerprints']}")
    check(backend is not None and backend[1] == "gloo",
          "process form: backend")
    check(sorted(ranks) == [0, 1] and all(
        x["hop_gathers_per_step"] == 2 * units
        and x["hop_bytes_per_step"] == wire
        for x in got["ranks"].values()),
        f"process form: the hop's gathers and bytes a step "
        f"{got['ranks']} != {2 * units} and wire_bytes {wire}")
    check(ranks == {0: want, 1: want}, f"process form: launches {ranks} != "
          f"{want} on each rank")
    print(f"  two processes on {backend[2]}, backend {backend[1]} (NCCL "
          "refuses two ranks on one card): gloo gathered the CUDA payload "
          f"itself, no staging by the hop; {2 * units} gathers and "
          f"{wire:,} bytes sent a step and a rank (= wire_bytes); losses "
          "and each rank's state (shared state and residual row) bitwise "
          f"phase 49's after {SYNC_PROC_STEPS} steps; launches per rank "
          f"{ranks[0]}; steps {step_ms} ms; {wall:.1f} s with start-up")
    return {"losses": got["losses"], "fingerprints": got["fingerprints"],
            "step_ms": step_ms, "backend": backend[1],
            "gathers_per_step": 2 * units, "bytes_per_step": wire,
            "wire_bytes": wire, "launches": ranks, "seconds": wall}


# ---------------------------------------------------------------------------
# Phases 51-53: the mesh (FSDP over "data", the pod x data sync,
# checkpoints across meshes), through the launcher's --mesh
# ---------------------------------------------------------------------------


FSDP_LAYERS = 2                   # phase 51: qwen3-8b at 2 of 36 layers
# (4, TRAIN_SYNC's depth, until the run passed 1000 s with phase 55)
FSDP_ROWS = (4, 512)              # the global batch: 2 rows a rank
FSDP_STEPS = 3
FSDP_LOSS_ATOL = 2e-3             # tests/test_spmd.py's sharded-vs-single
FSDP_MASTER_ATOL = 1e-3           # tolerance, at its optimizer (lr 0.1,
FSDP_LR = 0.1                     # warmup 100: the launcher's default)
FSDP_MOVE_RTOL = 2e-2             # each master leaf's change over the steps,
POD_DATA_MOVE_RTOL = 0.25         # in norm, against one process's: the
#                                   tolerance above is ~50x the change; the
#                                   compressed sync's top-n picks flip where
#                                   two ranks' sums round apart
POD_DATA_MASTER_ATOL = 3e-3       # a flipped pick moves one element of a
#                                   pod's payload by its whole |g + err|:
#                                   at lr 0.001 and 0.002 (steps 1-2) and
#                                   momentum 0.9, <= 3e-3 for |g + err| <= 1
POD_DATA_LAYERS = 6               # phase 52: granite at 6 of 24 layers
POD_DATA_STEPS = 3
CKPT_ARCH = "granite-moe-1b-a400m"  # phase 53 (SMOKE: expert stacks)
CKPT_STEPS = 2
DIGEST_RANK = re.compile(
    r"rank (\d+) coords (\{[^}]*\}) state_bytes (\d+) peak_bytes (\d+) "
    r"step_ms (\[[^\]]*\]) launches nm_spmm (\d+) fused_update (\d+) "
    r"grad_compress (\d+) grad_decompress_mean (\d+) "
    r"gathered_bytes_per_step (\d+) reduced_bytes_per_step (\d+) "
    r"hop_bytes_per_step (\d+) hop_gathers_per_step (\d+) "
    r"fingerprint ([0-9a-f]{32})")


def launch_mesh(dev, nproc, args):
    """Start the launcher under torchrun on ``nproc`` processes (on the
    card, or with ``--device cpu`` for a CPU rehearsal); returns (the
    process, its start)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.train",
           *args] + (["--device", "cpu"] if dev.type == "cpu" else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(root, "src"), os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), \
        time.perf_counter()


def launch_done(started, label, timeout=900):
    """Wait for a launcher run; fail the phase unless it exited 0.
    Returns (its stdout, its wall seconds with start-up)."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        print(out[-3000:])
        print(err[-3000:])
        check(False, f"{label}: the launcher did not end in {timeout} s")
    if proc.returncode != 0:
        print(out[-3000:])
        print(err[-3000:])
    check(proc.returncode == 0, f"{label}: the launcher exited "
          f"{proc.returncode}")
    return out, time.perf_counter() - t0


def mesh_digest(out):
    """The ``--digest`` lines of a mesh run: losses, and each rank's
    coordinates, state bytes, peak, step times, launches, bytes a step
    and the fingerprint of its blocks."""
    losses = eval(next(ln for ln in out.splitlines()
                       if ln.startswith("losses "))[7:])
    ranks = {}
    for mt in DIGEST_RANK.finditer(out):
        ranks[int(mt[1])] = {
            "coords": eval(mt[2]), "state_bytes": int(mt[3]),
            "peak_bytes": int(mt[4]), "step_ms": eval(mt[5]),
            "launches": {"nm_spmm": int(mt[6]), "fused_update": int(mt[7]),
                         "grad_compress": int(mt[8]),
                         "grad_decompress_mean": int(mt[9])},
            "gathered_bytes_per_step": int(mt[10]),
            "reduced_bytes_per_step": int(mt[11]),
            "hop_bytes_per_step": int(mt[12]),
            "hop_gathers_per_step": int(mt[13]), "fingerprint": mt[14]}
    return {"losses": losses, "ranks": ranks,
            "fingerprints": {r: x["fingerprint"] for r, x in ranks.items()}}


def _mesh_cfg(arch, layers, dev):
    """``arch`` at every width (SMOKE's for a CPU rehearsal), ``layers``
    deep, and the launcher's flags for it."""
    from repro_torch.configs import get_arch

    size = "smoke" if dev.type == "cpu" else "full"
    return (dataclasses.replace(getattr(get_arch(arch), size),
                                n_layers=layers),
            ["--arch", arch, f"--{size}", "--layers", str(layers)])


def master_gaps(ckpt, state, init):
    """(largest |a - b| over the master, largest ||a - b|| / ||a - x|| over
    its leaves) of a launcher run's final master (its checkpoint in
    ``ckpt``, mapped, not read whole) against ``state``'s, the
    one-process run's, from ``init`` (its initial master leaves)."""
    from repro_torch.optim import sgd
    from repro_torch.train.checkpoint import CheckpointManager

    like = {k: v for k, v in state.items()}
    saved = CheckpointManager(ckpt).restore(like, device="cpu", mmap=True)
    worst = move = 0.0
    for a, b, x in zip(sgd.tree_leaves(state["master"]),
                       sgd.tree_leaves(saved["master"]), init):
        b, x = b.to(a.device), x.to(a.device)
        worst = max(worst, float((a - b).abs().max()))
        move = max(move, float((a - b).norm() / (a - x).norm()))
    return worst, move


def phase_fsdp_update(dev, gen):
    """One qwen3-8b TRAIN layer (every width) at data=2: each rank's
    update of its blocks (``sgd.update`` with the logical shapes: one
    grouped fused_update launch over the 7 block sites, rows K/2 of
    q/k/v/gate/up, columns F/2 of o_proj and w_down) bitwise the slice
    of the whole layer's update given the same gradient (w', v', vals,
    idx, bp, mask); one rank's grouped launch timed against its byte
    bound and the plain version."""
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import fused_update as KF
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer_lm as T
    from repro_torch.optim import sgd
    from repro_torch.sharding import fsdp as F
    from repro_torch.train import step as ST

    cfg, _ = _mesh_cfg("qwen3-8b", 1, dev)
    sp = SparsityConfig(n=2, m=8, method="bdwp")
    opt = sgd.SGDConfig(lr=0.1, warmup_steps=2, total_steps=50)
    shape = {"data": 2, "model": 1}
    whole_specs = ST.state_pspecs(cfg, Mesh(shape), sp)
    specs = {k: whole_specs[k]["blocks"][0]
             for k in ("master", "momentum", "compute")}
    block = T.block_init(gen, cfg, device=dev)
    lshapes = sgd.shapes_of(block)

    def randn_like(x, scale, dtype=None):
        return (torch.randn(x.shape, generator=gen, device=dev) * scale).to(
            dtype or x.dtype)

    state = {"master": block, "momentum": sgd.tree_map(
        lambda _, w: randn_like(w, 1e-2), block), "step": 5}
    state["compute"] = sgd.pregen_tree(state["master"], sp, pack=True)
    grads = sgd.pregen_grads(state["compute"], [
        randn_like(x, 1e-2) for x in sgd.diff_leaves(state["compute"])])

    def clone(tree):
        return F.map_blocks(tree, tree, lambda t, _: t.clone())

    blocks = []
    for r in range(2):
        rmesh = Mesh(shape, rank=r)
        blocks.append(({k: clone(F.shard_tree(state[k], specs[k], rmesh))
                        for k in ("master", "momentum", "compute")},
                       F.shard_tree(grads, specs["master"], rmesh)))
    c0 = KF.launches
    new, comp = sgd.update(ST.state_core(clone(state)), grads, opt, sp,
                           prev_compute=state["compute"], pack=True)
    want = {"master": new["master"], "momentum": new["momentum"],
            "compute": comp}
    check(KF.launches - c0 == 1, "shard update: the whole layer is not "
          "one grouped launch")
    views = []
    for r, (mine, g) in enumerate(blocks):
        rmesh = Mesh(shape, rank=r)
        c0, s0 = KF.launches, KF.launched_sites
        got, gcomp = sgd.update(dict(mine, step=5), g, opt, sp,
                                prev_compute=mine["compute"], pack=True,
                                lshapes=lshapes)
        check((KF.launches - c0, KF.launched_sites - s0) == (1, 7),
              "shard update: a rank's 7 block sites are not one grouped "
              "launch")
        for key, tree in (("master", got["master"]),
                          ("momentum", got["momentum"]), ("compute", gcomp)):
            slices = F.tensors(F.shard_tree(want[key], specs[key], rmesh))
            outs = F.tensors(tree)
            check(len(slices) == len(outs) and all(
                bits_equal(a, b) for a, b in zip(slices, outs)),
                f"shard update: rank {r}'s {key} is not the slice of the "
                "whole layer's update")
        views.append([tuple(x.shape) for x in F.tensors(mine["master"])
                      if x.ndim == 2])
    print(f"  rank blocks {views[0]} / {views[1]}: each rank's update (one "
          "grouped fused_update over its 7 block sites) bitwise the slice "
          "of the whole layer's (w', v', vals, idx, bp, mask)")
    mine, g = blocks[0]
    s = UPDATE_SCALARS
    sites = []
    for w, gw, v in zip(F.tensors(mine["master"]), F.tensors(g),
                        F.tensors(mine["momentum"])):
        if w.ndim == 2:
            sites.append((w.view(-1, w.shape[-1]), gw.reshape(
                -1, w.shape[-1]), v.view(-1, w.shape[-1])))
    args = (s["lr"], s["mu"], s["wd"], s["lam"], 2, 8, "bdwp")
    t_k = time_ms(lambda i: KF.fused_update_sites(sites, *args), 1, iters=10)
    t_p = time_ms(lambda i: [ref.ref_fused_update(
        w, gw, v, n=2, m=8, axis=0, bp_mode="bdwp", **s)
        for w, gw, v in sites], 1, iters=2)
    t_b = sum(update_bound_ms(w.shape[0], w.shape[1], 2, 8)
              for w, _, _ in sites)
    elements = sum(w.numel() for w, _, _ in sites)
    print(f"  rank 0's grouped launch over {len(sites)} block sites "
          f"({elements:,} elements): {t_k:.4f} ms against a {t_b:.4f} ms "
          f"bound (bound/kernel {t_b / t_k:.2f}); plain {t_p:.3f} ms")
    del state, blocks, new, comp, want
    torch.cuda.empty_cache()
    embed = embed_grad_accumulation(dev, gen, cfg)
    return {"views": views[0], "elements": elements, "ms": t_k,
            "plain_ms": t_p, "bound_ms": t_b, "bound_by": "bytes",
            "library_ms": None, "embed_grad": embed}


def embed_grad_accumulation(dev, gen, cfg):
    """How the embedding table's gradient sums repeated tokens on the
    card: the lookup's backward (``table[tokens]``, as the one-process
    step takes it and the FSDP row lookup reproduces) against an fp32
    sum of the same rows, on the first FSDP_ROWS batch of phase 51 and a
    random bf16 row gradient; the most repeated tokens' rows' relative
    gaps are reported (no check: both steps take it the same way)."""
    from repro_torch.data.synthetic import lm_stream

    tokens = next(lm_stream(cfg.vocab, *FSDP_ROWS, device=dev,
                            seed=SEED))[1]["tokens"]
    table = torch.zeros((cfg.padded_vocab, cfg.d_model), device=dev,
                        dtype=torch.bfloat16, requires_grad=True)
    g = (torch.randn((*tokens.shape, cfg.d_model), generator=gen,
                     device=dev) * 1e-3).to(torch.bfloat16)
    (lookup,) = torch.autograd.grad(table[tokens], table, g)
    exact = torch.zeros(table.shape, dtype=torch.float32, device=dev)
    exact.index_add_(0, tokens.reshape(-1), g.reshape(-1, cfg.d_model).float())
    counts = torch.bincount(tokens.reshape(-1), minlength=cfg.padded_vocab)
    top = counts.argsort(descending=True)[:5]
    gaps = [float((lookup[t].float() - exact[t]).norm() / exact[t].norm())
            for t in top]
    shown = ", ".join(f"{x:.4f}" for x in gaps)
    print(f"  the embedding's lookup backward sums repeated tokens in "
          f"bf16: the 5 most repeated of {tokens.numel()} tokens "
          f"({counts[top].tolist()} times) are {shown} from an fp32 sum, "
          "relative")
    return {"repeats": counts[top].tolist(), "relative_gaps": gaps}


def phase_fsdp_train(dev, seed, during=None):
    """qwen3-8b at every width, FSDP_LAYERS layers, through the
    launcher's ``--mesh data=2``: two processes on the one card (gloo),
    FSDP_STEPS steps of the global FSDP_ROWS batch, each rank on its two
    rows.  Against the port's one-process step on the same rows (run
    here, beside a second launcher run): losses within FSDP_LOSS_ATOL
    and the master within FSDP_MASTER_ATOL (the reference's own
    sharded-vs-single tolerance at its optimizer); the second run
    bitwise the first (losses, every rank's fingerprint of its blocks);
    per rank: state bytes, peak, ms/step, bytes gathered and reduced a
    step, launches (2 x 7 x L nm_spmm and one fused_update a step).
    ``during()`` starts more work (a ``Background``) beside the second
    run and the one-process run (the first is timed alone); its result
    is returned under "during"."""
    import functools

    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.synthetic import lm_stream
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST

    cfg, args = _mesh_cfg("qwen3-8b", FSDP_LAYERS, dev)
    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(root, "build", "fsdp_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    args += ["--steps", str(FSDP_STEPS), "--batch", str(FSDP_ROWS[0]),
             "--seq", str(FSDP_ROWS[1]), "--lr", str(FSDP_LR), "--seed",
             str(seed), "--log-every", "1", "--digest", "--mesh", "data=2"]
    out, wall = launch_done(launch_mesh(dev, 2, args + ["--ckpt-dir",
                                                        ckpt]), "fsdp")
    for ln in out.splitlines():
        if ln.strip() and not ln.startswith("step "):
            print(f"  | {ln[:300]}")
    one = mesh_digest(out)
    second = launch_mesh(dev, 2, args)
    t_side = time.perf_counter()
    side = during() if during is not None else None
    sp = SparsityConfig(n=2, m=8, method="bdwp")
    opt = sgd.SGDConfig(lr=FSDP_LR, total_steps=FSDP_STEPS)
    state = ST.init_train_state(cfg, sp, seed=seed, device=dev)
    init = [x.to("cpu", copy=True) for x in sgd.tree_leaves(state["master"])]
    fn = functools.partial(ST.lm_train_step, cfg=cfg, sp_cfg=sp, opt_cfg=opt)
    data = lm_stream(cfg.vocab, *FSDP_ROWS, device=dev, seed=seed)
    losses = []
    for _ in range(FSDP_STEPS):
        state, met = fn(state, next(data)[1])
        losses.append(float(met["loss"]))
    worst, move = master_gaps(ckpt, state, init)
    del state, init
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    two = mesh_digest(launch_done(second, "fsdp, second run")[0])
    if side is not None:   # done before the next phase's timed runs
        side = side.result()
    gap = max(abs(a - b) for a, b in zip(one["losses"], losses))
    check(gap <= FSDP_LOSS_ATOL, f"fsdp: losses {one['losses']} vs one "
          f"process {losses}")
    check(worst <= FSDP_MASTER_ATOL, f"fsdp: master differs by {worst} "
          "from the one-process run's")
    check(move <= FSDP_MOVE_RTOL, f"fsdp: a master leaf's change is {move} "
          "of the one-process run's away from it")
    check(one["losses"] == two["losses"] and len(one["fingerprints"]) == 2
          and one["fingerprints"] == two["fingerprints"],
          "fsdp: two runs differ")
    want = {"nm_spmm": 2 * 7 * FSDP_LAYERS * FSDP_STEPS,
            "fused_update": FSDP_STEPS, "grad_compress": 0,
            "grad_decompress_mean": 0}
    check(sorted(one["ranks"]) == [0, 1] and all(
        r["launches"] == want for r in one["ranks"].values()),
        f"fsdp: launches {one['ranks']} != {want} on each rank")
    total = sum(r["state_bytes"] for r in one["ranks"].values())
    for r, x in sorted(one["ranks"].items()):
        steady = x["step_ms"][1:] or x["step_ms"]
        print(f"  rank {r}: state {x['state_bytes'] / 2**30:.2f} GiB of "
              f"{total / 2**30:.2f}, peak {x['peak_bytes'] / 2**30:.2f} GiB, "
              f"steps {x['step_ms']} ms (median after the first "
              f"{sorted(steady)[len(steady) // 2]:.1f}), gathered "
              f"{x['gathered_bytes_per_step']:,} and reduced "
              f"{x['reduced_bytes_per_step']:,} bytes a step; launches "
              f"{x['launches']}")
    print(f"  losses {one['losses']} against one process {losses} (largest "
          f"gap {gap:.2e}); master within {worst:.2e} of it, each leaf's "
          f"change within {move:.2e} of its change; the second run "
          f"bitwise the first; the first run {wall:.1f} s with start-up, "
          f"the second with the one-process run and the side work "
          f"{time.perf_counter() - t_side:.1f} s")
    return {"losses": one["losses"], "one_process_losses": losses,
            "loss_gap": gap, "master_gap": worst, "move_gap": move,
            "ranks": one["ranks"],
            "seconds": wall, "tokens": FSDP_ROWS[0] * FSDP_ROWS[1],
            "during": side}


def phase_pod_data_sync(dev, gen):
    """granite-moe-1b-a400m at every width, POD_DATA_LAYERS layers, mesh
    pod=2, data=2: each rank's compressed sync of its blocks (its pod's
    gradient blocks, its residual block; grad_compress and
    grad_decompress_mean once a unit of the rank's plan) bitwise the
    rank's slice of the one-card sync of the whole gradients (the mean
    and the residual); the sync of one rank's blocks and of the whole
    timed."""
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import grad_compress as KG
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import compress as C
    from repro_torch.optim import sgd
    from repro_torch.sharding import fsdp as F
    from repro_torch.train import step as ST
    from repro_torch.models import transformer_lm as T

    cfg, _ = _mesh_cfg("granite-moe-1b-a400m", POD_DATA_LAYERS, dev)
    sp = SparsityConfig(n=2, m=8, method="bdwp")
    gc = C.GradCompressConfig.from_sparsity(sp)
    shape = {"pod": 2, "data": 2}
    specs = ST.state_pspecs(cfg, Mesh(shape), sp, compress=True)
    aparams = T.abstract_params(cfg)
    lshapes = sgd.shapes_of(aparams)
    whole = sgd.tree_map(lambda _, x: (torch.randn(
        (2, *x.shape), generator=gen, device=dev) * 1e-2).to(
        torch.bfloat16), aparams)
    width = C.err_state_elems(aparams, sp.m)
    err = torch.randn((2, width), generator=gen, device=dev) * 1e-3

    def synced(grads, e):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = C.cross_pod_sync(grads, e, gc)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    (mean, new_err), whole_ms = synced(whole, err.clone())
    rows = []
    for d in range(2):
        rmesh = Mesh(shape, rank=d)     # (pod 0, data d); pod 1 alike
        sh = F.StateSharding(rmesh, specs, lshapes, sp.m)
        layout = sh.err_layout()
        mine = F.map_blocks(whole, specs["master"], lambda t, s: torch.stack(
            [F.block_of(t[p], F.shard_dim(s, rmesh), 2, d)
             for p in range(2)]))
        e = torch.cat([F.err_block(err[p:p + 1], layout, 2, d)
                       for p in range(2)])
        c0 = dict(KG.launches)
        (m_loc, e_loc), ms = synced(mine, e)
        units = len(C.plan_for(mine, gc.bucket_elems, gc.m,
                               stacked=True).units)
        got = {k: KG.launches[k] - c0[k] for k in KG.launches}
        check(got == {"grad_compress": units,
                      "grad_decompress_mean": units},
              f"pod x data sync: launches {got}, {units} units")
        check(all(bits_equal(a, b) for a, b in zip(
            F.tensors(m_loc), F.tensors(F.shard_tree(
                mean, specs["master"], rmesh)))),
              f"pod x data sync: data rank {d}'s mean is not the slice of "
              "the one-card sync's")
        for p in range(2):
            check(bits_equal(e_loc[p:p + 1], F.err_block(
                new_err[p:p + 1], layout, 2, d)), f"pod x data sync: rank "
                f"(pod {p}, data {d})'s residual block is not the slice of "
                "the one-card residual")
        rows.append({"data": d, "units": units, "ms": ms,
                     "local_width": layout.local_width})
    print(f"  ranks' blocks: {rows[0]['units']} units a sync, residual "
          f"{rows[0]['local_width']:,} of {width:,} columns a rank; each "
          "rank's mean and residual block bitwise the slice of the one-card "
          f"sync; sync of one data rank's blocks (both pods) "
          f"{rows[0]['ms']:.1f} / {rows[1]['ms']:.1f} ms, of the whole "
          f"{whole_ms:.1f} ms (host clock)")
    del whole, mean, new_err, err
    torch.cuda.empty_cache()
    return {"rows": rows, "whole_ms": whole_ms, "width": width}


def phase_pod_data_train(dev, seed, one):
    """granite-moe-1b-a400m at every width, POD_DATA_LAYERS layers,
    through the launcher's ``--mesh pod=2,data=2 --compress`` (topk):
    four processes on the one card, POD_DATA_STEPS steps of 4 x 1024
    tokens.  Against ``one``, phase 49's one-process step of the two
    pods on the same rows (its losses, and its master after as many
    steps): losses within FSDP_LOSS_ATOL, the master within
    POD_DATA_MASTER_ATOL and each leaf's change within
    POD_DATA_MOVE_RTOL of its change.  Per rank: the hop's bytes a step equal to
    ``wire_bytes`` of its blocks, launches (grad_compress =
    grad_decompress_mean = its units a step), ms/step, state bytes,
    peak."""
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer_lm as T
    from repro_torch.optim import compress as C
    from repro_torch.optim import sgd
    from repro_torch.train import step as ST

    cfg, args = _mesh_cfg("granite-moe-1b-a400m", POD_DATA_LAYERS, dev)
    args += ["--steps", str(POD_DATA_STEPS), "--batch",
             str(MOE_TRAIN_ROWS[0]), "--seq", str(MOE_TRAIN_ROWS[1]),
             "--compress", "--seed", str(seed), "--log-every", "1",
             "--digest", "--mesh", "pod=2,data=2"]
    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(root, "build", "pod_data_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    out, wall = launch_done(launch_mesh(dev, 4, args + ["--ckpt-dir", ckpt]),
                            "pod x data")
    for ln in out.splitlines():
        if ln.strip() and not ln.startswith("step "):
            print(f"  | {ln[:300]}")
    got = mesh_digest(out)
    sp = SparsityConfig(n=2, m=8, method="bdwp")
    like = ST.init_train_state(cfg, sp, device=dev, compress=True, n_pods=2)
    for x, w in zip(sgd.tree_leaves(like["master"]), one["masters"]["after"]):
        x.copy_(w)
    worst, move = master_gaps(ckpt, like, one["masters"]["init"])
    del like
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    ones = one["losses"][:POD_DATA_STEPS]
    gap = max(abs(a - b) for a, b in zip(got["losses"], ones))
    check(gap <= FSDP_LOSS_ATOL, f"pod x data: losses {got['losses']} vs "
          f"one process {ones}")
    check(worst <= POD_DATA_MASTER_ATOL, f"pod x data: master differs by "
          f"{worst} from the one-process run's")
    check(move <= POD_DATA_MOVE_RTOL, f"pod x data: a master leaf's change "
          f"is {move} of the one-process run's away from it")
    shape = {"pod": 2, "data": 2}
    specs = ST.state_pspecs(cfg, Mesh(shape), sp, compress=True)
    local = sgd.tree_map(lambda _, x, s: torch.empty(
        C.local_block_shape(x.shape, s, Mesh(shape)), device="meta"),
        T.abstract_params(cfg), specs["master"])
    plan = C.plan_for(local, 1 << 16, sp.m)
    total = sum(n for _, _, n in plan.units)
    ragged = sum(x.numel() for x, off in zip(sgd.tree_leaves(local),
                                             plan.offsets) if off is None)
    wire = C.wire_bytes(total, ragged, C.GradCompressConfig.from_sparsity(
        sp))
    units = len(plan.units)
    check(sorted(got["ranks"]) == [0, 1, 2, 3], "pod x data: four ranks")
    for r, x in sorted(got["ranks"].items()):
        check(x["hop_bytes_per_step"] == wire, f"pod x data: rank {r} sent "
              f"{x['hop_bytes_per_step']} bytes a step, wire_bytes {wire}")
        check(x["launches"]["grad_compress"] == units * POD_DATA_STEPS
              == x["launches"]["grad_decompress_mean"],
              f"pod x data: rank {r}'s sync launches {x['launches']}")
        check(x["launches"]["fused_update"] == POD_DATA_STEPS,
              f"pod x data: rank {r}'s fused_update launches")
        steady = x["step_ms"][1:] or x["step_ms"]
        print(f"  rank {r} {x['coords']}: state "
              f"{x['state_bytes'] / 2**30:.2f} GiB, peak "
              f"{x['peak_bytes'] / 2**30:.2f} GiB, steps {x['step_ms']} ms "
              f"(median after the first "
              f"{sorted(steady)[len(steady) // 2]:.1f}), hop "
              f"{x['hop_bytes_per_step']:,} bytes a step (wire_bytes of its "
              f"blocks {wire:,}), gathered {x['gathered_bytes_per_step']:,} "
              f"and reduced {x['reduced_bytes_per_step']:,}; launches "
              f"{x['launches']}")
    print(f"  losses {got['losses']} against phase 49's one process {ones} "
          f"(largest gap {gap:.2e}); master within {worst:.2e} of it, each "
          f"leaf's change within {move:.2e} of its change; {wall:.1f} s "
          "with start-up")
    return {"losses": got["losses"], "one_process_losses": ones,
            "loss_gap": gap, "master_gap": worst, "move_gap": move,
            "ranks": got["ranks"],
            "wire_bytes": wire, "units": units, "seconds": wall,
            "tokens": MOE_TRAIN_ROWS[0] * MOE_TRAIN_ROWS[1]}


class Background:
    """A phase run on a thread beside another phase's untimed part;
    ``result()`` waits for it and raises what it raised."""

    def __init__(self, fn):
        import threading

        self._out = {}

        def run():
            try:
                self._out["value"] = fn()
            except BaseException as exc:   # re-raised by result()
                self._out["error"] = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def phase_ckpt_reshard(dev, seed):
    """Checkpoints across meshes on the card, granite-moe SMOKE (expert
    stacks): the launcher at ``--mesh data=2`` saves after CKPT_STEPS
    steps (A); one process here restores A onto the card (data=1) and
    saves it (B) and a copy without the compute tree (C); the launcher
    resumes B and C at data=2 (no step left: each saves again).  B's
    files bitwise A's (2 -> 1 -> 2), C's compute tree, regenerated by
    ``restore_with_pregen``, bitwise A's (the update's).  It runs beside
    phase 51's untimed part (``Background``), so it prints nothing: its
    summary line comes back with its result."""
    import json
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.train import step as ST
    from repro_torch.train.checkpoint import CheckpointManager

    root = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(root, "build", "ckpt_reshard")
    dirs = {k: os.path.join(base, k) for k in "abc"}
    args = ["--arch", CKPT_ARCH, "--smoke", "--steps", str(CKPT_STEPS),
            "--batch", "8", "--seq", "32", "--seed", str(seed),
            "--mesh", "data=2", "--log-every", "1"]
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    launch_done(launch_mesh(dev, 2, args + ["--ckpt-dir", dirs["a"]]),
                "checkpoint A")
    cfg, sp = get_arch(CKPT_ARCH).smoke, SparsityConfig(n=2, m=8)
    like = ST.init_train_state(cfg, sp, seed=seed, device=dev)
    one = CheckpointManager(dirs["a"]).restore(like, device=dev)
    check(one["step"] == CKPT_STEPS and next(iter(
        one["master"]["embed"].values())).device == dev,
        "checkpoint: the one-process restore")
    CheckpointManager(dirs["b"]).save(CKPT_STEPS, one, blocking=True)
    CheckpointManager(dirs["c"]).save(CKPT_STEPS, {
        k: v for k, v in one.items() if k != "compute"}, blocking=True)
    runs = [launch_mesh(dev, 2, args + ["--resume", "--ckpt-dir", dirs[k]])
            for k in "bc"]
    for k, run in zip("bc", runs):
        out, _ = launch_done(run, f"checkpoint {k.upper()} resumed")
        check("done: 0 steps" in out, f"checkpoint {k.upper()}: resumed "
              "with steps left")

    def leaves(d):
        path = os.path.join(d, f"step_{CKPT_STEPS:08d}")
        man = json.load(open(os.path.join(path, "manifest.json")))
        return [torch.load(os.path.join(path, f"leaf_{i:05d}.pt"),
                           weights_only=True) if x["kind"] == "tensor"
                else x for i, x in enumerate(man["leaves"])]

    def same(xs, ys):
        return len(xs) == len(ys) > 0 and all(
            bits_equal(x, y) if isinstance(x, torch.Tensor) else x == y
            for x, y in zip(xs, ys))

    a, b, c = (leaves(dirs[k]) for k in "abc")
    check(same(a, b), "checkpoint: data=2 -> 1 -> 2 is not bitwise")
    check(same(a, c), "checkpoint: restore_with_pregen's compute tree is "
          "not the update's")
    shutil.rmtree(base, ignore_errors=True)
    wall = time.perf_counter() - t0
    return {"leaves": len(a), "seconds": wall, "summary": (
        f"  {len(a)} leaves: saved at data=2, restored at data=1 on the "
        "card and saved, resumed at data=2 and saved: bitwise; a "
        "checkpoint without a compute tree resumed at data=2 "
        "(restore_with_pregen): bitwise the update's compute tree; "
        f"{wall:.1f} s beside phase 51")}


FLEET_LENS = (9, 32, 17, 24)    # phase 54's distinct prompts, each sent twice
FLEET_NEW = 16
FLEET_ROUTERS = ("prefix", "least_loaded", "random")


def _fleet_run(label, fleet, waves, solo, cfg, submit=None):
    """Drive ``fleet`` with the nm_spmm counter from 0: each wave of
    requests (indices into ``solo``) is submitted, then the fleet steps
    once, so a later wave finds the earlier waves' prefixes pooled; then
    it drains.  Every stream must equal its solo stream and the launches
    7 x L x (prefills + decode steps).  ``submit(fleet, prompts)``
    replaces all that for one wave (the async frontend) and returns the
    streams in request order."""
    from repro_torch.kernels import nm_spmm as K

    requests = [i for wave in waves for i in wave]
    prompts = [solo[i][0] for i in requests]
    K.launches = 0
    t0 = time.perf_counter()
    if submit is None:
        rids = []
        for wave in waves:
            rids += [fleet.submit(solo[i][0], max_new_tokens=FLEET_NEW)
                     for i in wave]
            fleet.step()
        while fleet.n_pending:
            fleet.step()
        done = {r.rid: r for r in fleet.finished_requests}
        streams = [done[r].tokens for r in rids]
        hits = sum(done[r].prefix_hit for r in rids)
        fleet.harvest()
    else:
        streams, hits = submit(fleet, prompts), None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launches
    st = fleet.stats()
    want = packed_per_forward(cfg) * (st["prefill_steps"]
                                      + st["decode_steps"])
    tokens = sum(len(t) for t in streams)
    replica_prefills = [e["prefill_steps"] for e in st["engines"]]
    out = {"fleet_steps": st["steps"], "prefill_steps": st["prefill_steps"],
           "replica_prefill_steps": replica_prefills,
           "decode_steps": st["decode_steps"], "prefix_hits": hits,
           "routed_by_depth": st["routed_by_depth"],
           "store": st["store"], "launches": launches, "want": want,
           "wall_s": wall, "ms_per_fleet_step": 1e3 * wall / st["steps"],
           "tokens": tokens, "tok_per_s": tokens / wall}
    print(f"  {label}: {len(prompts)} requests, {st['steps']} fleet steps, "
          f"{st['prefill_steps']} prefills (decode replicas "
          f"{replica_prefills}), {st['decode_steps']} decode steps, prefix "
          f"hits {hits}, routed_by_depth {st['routed_by_depth']}; "
          f"{out['ms_per_fleet_step']:.2f} ms a fleet step, "
          f"{out['tok_per_s']:.1f} tok/s; nm_spmm launches {launches} "
          f"(want {want})")
    check(launches > 0 and launches == want,
          f"fleet {label}: nm_spmm launch count")
    for k, (i, got) in enumerate(zip(requests, streams)):
        check(list(got) == solo[i][1], f"fleet {label}: request {k} "
              f"(prompt {i}) != its solo stream")
    return out


def phase_fleet(dev, seed, cfg):
    """qwen3-8b at ``cfg``, 2:8 u4 packed once, through the fleet."""
    import asyncio

    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.launch import spmd
    from repro_torch.serve import AsyncFrontend, FleetConfig, ServeFleet
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    sp = SparsityConfig(n=2, m=8, method="bdwp")
    scfg = ServeConfig(n_slots=4, prompt_bucket=32, packed=True)
    torch.cuda.reset_peak_memory_stats()
    store, compact, compact_variants, pack_s = pack_full(dev, seed, cfg, sp)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in FLEET_LENS]
    first = list(range(len(prompts)))
    waves = [first, first]      # the repeats arrive a fleet step later

    engine = ServeEngine(store, cfg, sp, scfg, device=dev)
    engine.submit(prompts[0][:3], max_new_tokens=2)      # warm-up
    engine.run()
    engine.reset()
    K.launches = 0
    solo = []
    for p in prompts:
        rid = engine.submit(p, max_new_tokens=FLEET_NEW)
        solo.append((p, engine.run()[rid]))
    st = engine.stats()
    want = packed_per_forward(cfg) * (st["prefill_steps"]
                                      + st["decode_steps"])
    print(f"  solo: {len(prompts)} prompts of {FLEET_LENS} tokens, "
          f"{FLEET_NEW} new each, {st['prefill_steps']} prefills, "
          f"{st['decode_steps']} decode steps; nm_spmm launches "
          f"{K.launches} (want {want})")
    check(K.launches == want, "fleet solo: nm_spmm launch count")
    check(all(len(s) == FLEET_NEW for _, s in solo), "fleet solo: lengths")
    runs = {"solo": {"launches": K.launches, "want": want, **st}}
    del engine

    # the control: one engine behind the same queue, on the same trace
    fleet = ServeFleet(store, cfg, sp, scfg, FleetConfig(n_replicas=1),
                       device=dev)
    runs["one_engine"] = _fleet_run("one engine (1 replica, prefix)", fleet,
                                    waves, solo, cfg)
    for router in FLEET_ROUTERS:
        fleet = ServeFleet(store, cfg, sp, scfg,
                           FleetConfig(n_replicas=2, router=router),
                           device=dev)
        runs[router] = _fleet_run(f"colocated {router}", fleet, waves,
                                  solo, cfg)
    check(runs["prefix"]["prefix_hits"] > 0, "fleet prefix: no prefix hit")
    fleet = ServeFleet(store, cfg, sp, scfg,
                       FleetConfig(n_replicas=2, router="prefix",
                                   disaggregate=True, n_prefill=1),
                       device=dev)
    runs["disaggregated"] = r = _fleet_run(
        "disaggregated 1 + 2", fleet, waves, solo, cfg)
    check(r["replica_prefill_steps"] == [0, 0],
          "fleet disaggregated: a decode replica ran a prefill")
    check(r["store"]["size"] == 0, "fleet disaggregated: a lane left behind")

    def concurrent(fleet, prompts):
        async def main():
            fr = AsyncFrontend(fleet)
            return await asyncio.gather(
                *[fr.generate(p, max_new_tokens=FLEET_NEW) for p in prompts])
        return asyncio.run(main())

    fleet = ServeFleet(store, cfg, sp, scfg, FleetConfig(n_replicas=2),
                       device=dev)
    runs["async"] = _fleet_run("AsyncFrontend, 4 concurrent", fleet,
                               [first], solo, cfg, submit=concurrent)
    del fleet
    try:
        spmd.fleet_meshes(2)
    except ValueError as e:
        print(f"  fleet_meshes(2) on {torch.cuda.device_count()} card: "
              f"ValueError ({e})")
    else:
        raise RuntimeError("fleet_meshes(2) did not raise on one card")
    check(spmd.fleet_meshes(1) == [torch.device("cuda", 0)],
          "fleet_meshes(1) != [cuda:0]")
    peak = torch.cuda.max_memory_allocated()
    card = card_line()
    print(f"  max_memory_allocated {peak / 2**30:.2f} GiB; {card}")
    del store
    return {"runs": runs, "compact_launches": compact,
            "compact_variants": compact_variants, "pack_s": pack_s,
            "launches": sum(v["launches"] for v in runs.values()),
            "max_memory_allocated": peak, "card": card}


TP_LENS = (9, 32, 17, 24)       # phase 55's prompts: the last two join
TP_JOIN_AFTER = 3               # after this many engine steps
TP_NEW = 16
TP_RANKS = 2
# TP vs one-process logits, teacher-forced (the same tokens in): set
# from the CPU rehearsal of this phase (PERF.md, PR 30) before the first
# run on the card; a stream may part from its one-process stream only
# where the one-process top-two gap is under it
TP_LOGIT_ATOL = 0.2             # 4.5 x the 0.0442 of tools/tp_serve_cpu.py
TP_TIMEOUT = 600                # seconds for the ranks' run


def tp_drive(engine, prompts):
    """Submit the first two prompts, step the engine TP_JOIN_AFTER times,
    submit the rest (they join mid-flight), drain; the streams in
    request order."""
    rids = [engine.submit(p, max_new_tokens=TP_NEW) for p in prompts[:2]]
    for _ in range(TP_JOIN_AFTER):
        engine.step()
    rids += [engine.submit(p, max_new_tokens=TP_NEW) for p in prompts[2:]]
    done = engine.run()
    return [done[r] for r in rids]


@contextlib.contextmanager
def tp_step_log(engine, log):
    """Append every serve step the engine runs to ``log``: its kind, the
    slots it serves (over DP ranks, the rank's own), its last-position
    logits (fp32, on the host; a rank's rows at their slot numbers) and
    the collectives it took part in (``sharding.tp.stats`` deltas)."""
    from repro_torch.sharding import tp
    from repro_torch.train import step as ST

    orig = ST.lm_prefill_step, ST.lm_decode_step
    batcher = engine.batcher

    def wrap(kind, fn):
        def run(*a, **kw):
            rows = [0] if kind == "prefill" else [
                s for s in sorted(engine._running) if batcher._holds(s)]
            before = dict(tp.stats)
            logits, cache = fn(*a, **kw)
            got = logits[:, -1].float().cpu()
            if kind == "decode" and got.shape[0] != batcher.kv.n_slots:
                # the rank's slots over DP, at their slot numbers
                full = torch.full((batcher.kv.n_slots, got.shape[1]),
                                  float("nan"))
                full[batcher.lo:batcher.lo + got.shape[0]] = got
                got = full
            log.append({"kind": kind, "rows": rows, "logits": got,
                        "collectives": {k: v - before[k]
                                        for k, v in tp.stats.items()}})
            return logits, cache
        return run

    def step():   # a decode step's collectives: its token gather too
        before = dict(tp.stats)
        out = batch_step()
        log[-1]["collectives"] = {k: v - before[k]
                                  for k, v in tp.stats.items()}
        return out

    batch_step = batcher.step
    ST.lm_prefill_step = wrap("prefill", orig[0])
    ST.lm_decode_step = wrap("decode", orig[1])
    batcher.step = step
    try:
        yield log
    finally:
        ST.lm_prefill_step, ST.lm_decode_step = orig
        del batcher.step


def packed_tensors(tree) -> list:
    """Every tensor of a packed tree in order, a ``PackedOp``'s or a
    ``SharedOp``'s vals and idx in turn (for
    ``train.checkpoint.state_fingerprint``)."""
    from repro_torch.core.operand import PackedOp, SharedOp

    if isinstance(tree, dict):
        return [t for v in tree.values() for t in packed_tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in packed_tensors(v)]
    if isinstance(tree, (PackedOp, SharedOp)):
        return [tree.vals, tree.idx]
    return [tree]


def _tp_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _tp_rank(rank, world, store, out, dev_name, seed, cfg, prompts):
    """One rank of phase 55: the seed's weights drawn whole, the engine
    over the mesh data=1,model=``world`` (its blocks packed on the
    card), the phase's requests with every count from 0; its results to
    ``out``/rank{rank}.pt."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import nm_compact as KC
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.launch.mesh import mesh_over_group
    from repro_torch.models import transformer_lm as T
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.sharding import tp
    from repro_torch.train.checkpoint import state_fingerprint

    dev = torch.device(dev_name)
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cpu":
        torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT))
    mesh = mesh_over_group({"data": 1, "model": world})
    sp = SparsityConfig(n=2, m=8, method="bdwp")
    gen = T.generator(seed, dev)
    params = T.init_shell(cfg, gen, device=dev, dtype=torch.bfloat16)
    params["blocks"] = list(T.iter_blocks(cfg, gen, device=dev,
                                          dtype=torch.bfloat16))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    KC.launches = 0
    KC.variant_launches.update(dict.fromkeys(KC.VARIANTS, 0))
    engine = ServeEngine(params, cfg, sp, ServeConfig(
        n_slots=4, prompt_bucket=32, packed=True, idx_bits=4), device=dev,
        mesh=mesh)
    _tp_sync(dev)
    compact, variants = KC.launches, dict(KC.variant_launches)
    del params
    fingerprint = state_fingerprint(packed_tensors(engine.store.params))
    engine.submit(prompts[0][:3], max_new_tokens=2)      # warm-up
    engine.run()
    engine.reset()
    _tp_sync(dev)
    K.launches = 0
    tp.reset_stats()
    log = []
    with tp_step_log(engine, log):
        t0 = time.perf_counter()
        streams = tp_drive(engine, prompts)
        _tp_sync(dev)
        wall = time.perf_counter() - t0
    torch.save({"streams": streams, "log": log, "launches": K.launches,
                "compact": compact, "compact_variants": variants,
                "fingerprint": fingerprint, "stats": engine.stats(),
                "store_bytes": engine.store.total_bytes, "wall_s": wall,
                "coords": mesh.coords,
                "peak": (torch.cuda.max_memory_allocated()
                         if dev.type == "cuda" else 0)},
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def tp_block_proj(cfg, parts):
    """The seven projection shapes (name, K, F) of one rank's blocks at
    "model" = ``parts``: q/k/v and w_gate/w_up by columns, o_proj and
    w_down by rows."""
    rows = {"o_proj", "w_down"}
    return [(name, k // parts if name in rows else k,
             f if name in rows else f // parts)
            for name, k, f in arch_proj(cfg)]


def _tp_parting(solo_log, log, label, slots=None):
    """Walk the two runs' steps in order: the largest |rank - one-process|
    logit over the rank's served rows up to and with the first step
    where an argmax differs, that step (None if none) and the
    one-process top-two gap there.  A step must serve the one-process
    step's rows, a decode step those of them in the rank's ``slots``
    [lo, hi) where it holds a block of them (over DP ranks)."""
    worst, part = 0.0, None
    check(len(log) >= 1, f"{label}: no serve step")
    for s, (a, b) in enumerate(zip(solo_log, log)):
        want = (a["rows"] if slots is None or a["kind"] == "prefill" else
                [r for r in a["rows"] if slots[0] <= r < slots[1]])
        check(a["kind"] == b["kind"] and b["rows"] == want,
              f"{label}: step {s} is not the one-process step")
        if not b["rows"]:
            continue
        x, y = a["logits"][b["rows"]], b["logits"][b["rows"]]
        worst = max(worst, float((x - y).abs().max()))
        flips = (x.argmax(-1) != y.argmax(-1)).nonzero()
        if len(flips):
            i = int(flips[0, 0])
            top2 = x[i].topk(2).values
            part = {"step": s, "kind": a["kind"], "slot": b["rows"][i],
                    "top2_gap": float(top2[0] - top2[1])}
            return worst, part
    check(len(log) == len(solo_log), f"{label}: step count differs")
    return worst, part


def phase_tp_serve(dev, seed, cfg):
    """qwen3-8b at ``cfg``'s widths, 2:8 u4, served on one engine and
    then over "model" = TP_RANKS ranks (processes on the one card,
    gloo), the same requests; see the module docstring, phase 55."""
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.sharding import tp
    from repro_torch.train.checkpoint import state_fingerprint

    sp = SparsityConfig(n=2, m=8, method="bdwp")
    scfg = ServeConfig(n_slots=4, prompt_bucket=32, packed=True, idx_bits=4)
    gen = torch.Generator(device=dev).manual_seed(seed)
    block_proj = tp_block_proj(cfg, TP_RANKS)
    spmm_rows, spmm_err = spmm_case_checks(
        dev, gen, "tp rank block", [(n, 4, k, f, 4) for n, k, f in
                                    block_proj])
    pack_rows, pack_tot = pack_timing(dev, gen, [
        (n, k, f, cfg.n_layers) for n, k, f in block_proj], "tp rank block")
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    store, compact, compact_variants, _ = pack_full(dev, seed, cfg, sp)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in TP_LENS]
    engine = ServeEngine(store, cfg, sp, scfg, device=dev)
    engine.submit(prompts[0][:3], max_new_tokens=2)      # warm-up
    engine.run()
    engine.reset()
    torch.cuda.synchronize()
    K.launches = 0
    solo_log = []
    with tp_step_log(engine, solo_log):
        t0 = time.perf_counter()
        solo = tp_drive(engine, prompts)
        torch.cuda.synchronize()
        solo_wall = time.perf_counter() - t0
    st = engine.stats()
    per_fwd = packed_per_forward(cfg)
    check(K.launches == per_fwd * (st["prefill_steps"] + st["decode_steps"]),
          "tp serve one process: nm_spmm launch count")
    check([len(s) for s in solo] == [TP_NEW] * len(prompts),
          "tp serve one process: lengths")
    want_fp = {"whole": state_fingerprint(packed_tensors(store.params))}
    for r in range(TP_RANKS):
        mesh = Mesh({"data": 1, "model": TP_RANKS}, r)
        specs = spmd.serve_shardings(cfg, mesh, sp, n_slots=scfg.n_slots,
                                     max_len=scfg.max_len, packed=True,
                                     idx_bits=4)["params"]
        want_fp[r] = state_fingerprint(packed_tensors(
            tp.serve_blocks(store.params, specs, mesh)))
    one = {"store_bytes": store.total_bytes, "wall_s": solo_wall,
           "stats": st, "launches": K.launches,
           "ms_per_step": 1e3 * solo_wall / st["steps"],
           "tok_per_s": st["decoded_tokens"] / solo_wall}
    print(f"  one process: {st['prefill_steps']} prefills, "
          f"{st['decode_steps']} decode steps, {one['ms_per_step']:.2f} ms a "
          f"step, {one['tok_per_s']:.1f} tok/s; store "
          f"{store.total_bytes / 2**30:.3f} GiB")
    del engine, store
    torch.cuda.empty_cache()

    import tempfile

    import torch.multiprocessing as mp

    out = tempfile.mkdtemp(prefix="tp_serve_")
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _tp_rank, args=(TP_RANKS, os.path.join(out, "store"), out, str(dev),
                        seed, cfg, prompts),
        nprocs=TP_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + TP_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"tp serve: the ranks did not end in {TP_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks_wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(TP_RANKS)]
    shutil.rmtree(out, ignore_errors=True)

    kv = 0 if cfg.n_kv % TP_RANKS == 0 else 2 * cfg.n_layers
    want_coll = {"all_reduces": 2 * cfg.n_layers, "embed_lookups": 1,
                 "gathers": 1 + kv}
    report = {"one_process": one, "ranks": {}, "ranks_wall_s": ranks_wall,
              "want_collectives": want_coll}
    for r, res in enumerate(ranks):
        label = f"tp serve rank {r}"
        rst = res["stats"]
        fwd = rst["prefill_steps"] + rst["decode_steps"]
        check(res["compact"] == per_fwd, f"{label}: nm_compact launch count")
        check(res["compact_variants"]["vector"] == res["compact"],
              f"{label}: an element-pack launch missed the vector variant")
        check(res["launches"] == per_fwd * fwd and res["launches"] > 0,
              f"{label}: nm_spmm launch count")
        check(res["fingerprint"] == want_fp[r],
              f"{label}: its store is not its blocks of the one-process "
              "store")
        check(res["streams"] == ranks[0]["streams"],
              f"{label}: streams differ from rank 0's")
        check(all(torch.equal(a["logits"], b["logits"])
                  for a, b in zip(res["log"], ranks[0]["log"])),
              f"{label}: logits differ from rank 0's")
        per_kind = {}
        for e in res["log"]:
            c = e["collectives"]
            check(all(c[k] == v for k, v in want_coll.items()),
                  f"{label}: collectives of a {e['kind']} step {c}, want "
                  f"{want_coll}")
            per_kind.setdefault(e["kind"], []).append(c)
        coll = {kind: {k: sum(c[k] for c in cs) / len(cs) for k in cs[0]}
                for kind, cs in per_kind.items()}
        worst, part = _tp_parting(solo_log, res["log"], label)
        check(worst <= TP_LOGIT_ATOL,
              f"{label}: teacher-forced logits {worst:.3e} from the "
              f"one-process logits, over {TP_LOGIT_ATOL}")
        if part is None:
            check(res["streams"] == solo, f"{label}: streams differ")
        else:
            print(f"  {label}: parts from the one-process streams at step "
                  f"{part['step']} ({part['kind']}, slot {part['slot']}), "
                  f"one-process top-two gap {part['top2_gap']:.3e}")
            check(part["top2_gap"] < TP_LOGIT_ATOL,
                  f"{label}: parted where the one-process top-two gap "
                  f"{part['top2_gap']:.3e} is not under {TP_LOGIT_ATOL}")
        row = {"coords": res["coords"], "launches": res["launches"],
               "compact_launches": res["compact"],
               "compact_variants": res["compact_variants"],
               "weight_bytes": res["store_bytes"], "peak_bytes": res["peak"],
               "ms_per_step": 1e3 * res["wall_s"] / rst["steps"],
               "tok_per_s": rst["decoded_tokens"] / res["wall_s"],
               "collectives_per_step": coll, "max_logit_gap": worst,
               "parting": part, "stats": rst,
               "streams_equal_one_process": res["streams"] == solo}
        report["ranks"][r] = row
        print(f"  {label} {res['coords']}: weights "
              f"{res['store_bytes'] / 2**30:.3f} GiB (one process "
              f"{one['store_bytes'] / 2**30:.3f} GiB), "
              f"peak {res['peak'] / 2**30:.2f} GiB, {row['ms_per_step']:.2f} "
              f"ms a step, {row['tok_per_s']:.1f} tok/s (smoke readings); "
              f"nm_spmm launches {res['launches']} (want {per_fwd * fwd}), "
              f"nm_compact {res['compact']} {res['compact_variants']}; "
              f"teacher-forced logit gap {worst:.3e} (limit "
              f"{TP_LOGIT_ATOL}); streams equal the one-process streams: "
              f"{row['streams_equal_one_process']}")
        for kind, c in coll.items():
            print(f"  {label} per {kind} step: {c['all_reduces']:.0f} "
                  f"all-reduces ({c['all_reduce_bytes']:.0f} B reduced), "
                  f"{c['embed_lookups']:.0f} embedding lookup "
                  f"({c['embed_bytes']:.0f} B), {c['gathers']:.0f} gathers "
                  f"({c['gather_bytes']:.0f} B); want {want_coll}")
    card = card_line()
    print(f"  ranks' run {ranks_wall:.1f} s with start-up; {card}")
    report.update(card=card, spmm_rows=spmm_rows, spmm_err=spmm_err,
                  pack_rows=pack_rows, pack_total=pack_tot,
                  compact_launches=compact, compact_variants=compact_variants,
                  # phase 56's one engine: popped before --out is written
                  handoff={"streams": solo, "log": solo_log,
                           "prompts": prompts, "fingerprints": want_fp})
    return report


DP_MESHES = ((1, 2, 2), (2, 2, 1))  # phase 56's engines: (pod, data, model)
DP_RANKS = 4
LM_SERVE_ROWS = (4, 32)          # phase 56's build_lm_serve rows x prompt
LM_SERVE_STEPS = 16              # its shared-cursor decode steps
DP_AXES3 = ("pod", "data", "model")


def seat_rows(cache, pre, s):
    """A prefill cache of ``s`` positions into the first ``s`` of a
    deeper cache (every row), its shared cursors at ``s``."""
    for dst, src in zip(cache["layers"], pre["layers"]):
        for key, t in src.items():
            if isinstance(t, torch.Tensor):
                dst[key][:, :t.shape[1]] = t
            else:
                dst[key] = s
    return cache


def shared_block_tensors(tree, specs, r):
    """The ``SharedOp`` blocks of a rank's tree in order, each as [vals,
    rows]: a row block's rows back on the whole K (+ r K / M)."""
    from repro_torch.core.operand import SharedOp

    if isinstance(tree, dict):
        return [t for k in tree for t in shared_block_tensors(
            tree[k], specs[k], r)]
    if isinstance(tree, list):
        return [t for v, sp in zip(tree, specs)
                for t in shared_block_tensors(v, sp, r)]
    if isinstance(tree, SharedOp):
        row = bool(specs.idx) and specs.idx[0] is not None
        return [tree.vals, tree.idx + r * tree.k if row else tree.idx]
    return []


def shared_block_slices(whole, specs, r, parts):
    """``shared_block_tensors``' list from the whole pack itself: a
    column site's columns of ``vals`` and its rows whole, a row site's
    rows of both (plain slices, no ``sharding.tp``)."""
    from repro_torch.core.operand import SharedOp

    if isinstance(whole, dict):
        return [t for k in whole for t in shared_block_slices(
            whole[k], specs[k], r, parts)]
    if isinstance(whole, list):
        return [t for v, sp in zip(whole, specs)
                for t in shared_block_slices(v, sp, r, parts)]
    if isinstance(whole, SharedOp):
        kc, f = whole.vals.shape
        if bool(specs.idx) and specs.idx[0] is not None:
            rows = slice(r * kc // parts, (r + 1) * kc // parts)
            return [whole.vals[rows].contiguous(), whole.idx[rows]]
        return [whole.vals[:, r * f // parts:(r + 1) * f // parts]
                .contiguous(), whole.idx]
    return []


def _dp_lm_serve(dev, cfg, sp, params, mesh, rows, forced):
    """Phase 56 part 2 on one rank: the whole weights shared-packed on
    the card, cut to the rank's blocks, then build_lm_serve's prefill of
    its rows and LM_SERVE_STEPS shared-cursor decode steps fed the
    one-process tokens ``forced``; the whole batch's logits a forward."""
    from repro_torch.core import bdwp
    from repro_torch.kernels import nm_compact as KC
    from repro_torch.kernels import nm_spmm_shared as KS
    from repro_torch.models import transformer_lm as T
    from repro_torch.sharding import tp
    from repro_torch.train import step as ST
    from repro_torch.train.checkpoint import state_fingerprint

    b, s = rows.shape
    KC.launches = 0
    KC.variant_launches.update(dict.fromkeys(KC.VARIANTS, 0))
    whole = bdwp.pack_tree_shared(params, sp, device=dev)
    _tp_sync(dev)
    compact, variants = KC.launches, dict(KC.variant_launches)
    tokens = torch.empty((b, s), dtype=torch.int64, device="meta")
    pre = ST.build_lm_serve(cfg, mesh, sp, {"tokens": tokens}, prefill=True,
                            packed=True)
    dec = ST.build_lm_serve(cfg, mesh, sp, {
        "cache": T.init_lm_cache(cfg, b, s + LM_SERVE_STEPS, device="meta"),
        "token": tokens[:, :1], "pos": torch.empty((), device="meta")},
        packed=True)
    blocks = tp.serve_blocks(whole, pre.state_shardings, mesh)
    del whole
    fingerprint = state_fingerprint(shared_block_tensors(
        blocks, pre.state_shardings, mesh.coord("model")))
    lo, hi = tp.slot_block(b, mesh)
    rows = torch.as_tensor(rows, device=dev)
    forced = torch.as_tensor(forced, device=dev)
    _tp_sync(dev)
    KS.launches = 0
    tp.reset_stats()
    logits, colls = [], []
    t0 = time.perf_counter()
    before = dict(tp.stats)
    lg, cache1 = pre.step_fn(blocks, {"tokens": rows[lo:hi]})
    colls.append({k: v - before[k] for k, v in tp.stats.items()})
    logits.append(lg[:, -1].float().cpu())
    cache = seat_rows(tp.init_cache(cfg, hi - lo, s + LM_SERVE_STEPS, mesh,
                                    device=dev), cache1, s)
    del cache1
    for i in range(LM_SERVE_STEPS):
        before = dict(tp.stats)
        lg, cache = dec.step_fn(blocks, cache, forced[i, lo:hi, None], s + i)
        colls.append({k: v - before[k] for k, v in tp.stats.items()})
        logits.append(lg[:, -1].float().cpu())
    _tp_sync(dev)
    wall = time.perf_counter() - t0
    return {"logits": torch.stack(logits), "collectives": colls,
            "launches": KS.launches, "compact": compact,
            "compact_variants": variants, "fingerprint": fingerprint,
            "rows": (lo, hi), "wall_s": wall,
            "weight_bytes": sum(t.numel() * t.element_size()
                                for t in packed_tensors(blocks)
                                if isinstance(t, torch.Tensor))}


def _dp_rank(rank, world, store, out, dev_name, seed, cfg, prompts, rows,
             forced):
    """One rank of phase 56: the seed's weights drawn whole, the engine
    over each of DP_MESHES (its blocks packed on the card) on phase 55's
    requests with every count from 0, then ``_dp_lm_serve`` over (1, 2,
    2); its results to ``out``/rank{rank}.pt."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import nm_compact as KC
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.launch.mesh import mesh_over_group
    from repro_torch.models import transformer_lm as T
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.sharding import tp
    from repro_torch.train.checkpoint import state_fingerprint

    dev = torch.device(dev_name)
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT))
    sp = SparsityConfig(n=2, m=8, method="bdwp")
    gen = T.generator(seed, dev)
    params = T.init_shell(cfg, gen, device=dev, dtype=torch.bfloat16)
    params["blocks"] = list(T.iter_blocks(cfg, gen, device=dev,
                                          dtype=torch.bfloat16))
    res, meshes = {"engines": {}}, {}
    for shape in DP_MESHES:
        mesh = meshes[shape] = mesh_over_group(dict(zip(DP_AXES3, shape)))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        KC.launches = 0
        KC.variant_launches.update(dict.fromkeys(KC.VARIANTS, 0))
        engine = ServeEngine(params, cfg, sp, ServeConfig(
            n_slots=4, prompt_bucket=32, packed=True, idx_bits=4),
            device=dev, mesh=mesh)
        _tp_sync(dev)
        compact, variants = KC.launches, dict(KC.variant_launches)
        fingerprint = state_fingerprint(packed_tensors(engine.store.params))
        engine.submit(prompts[0][:3], max_new_tokens=2)      # warm-up
        engine.run()
        engine.reset()
        _tp_sync(dev)
        K.launches = 0
        tp.reset_stats()
        log = []
        with tp_step_log(engine, log):
            t0 = time.perf_counter()
            streams = tp_drive(engine, prompts)
            _tp_sync(dev)
            wall = time.perf_counter() - t0
        res["engines"][shape] = {
            "streams": streams, "log": log, "launches": K.launches,
            "compact": compact, "compact_variants": variants,
            "fingerprint": fingerprint, "stats": engine.stats(),
            "store_bytes": engine.store.total_bytes, "wall_s": wall,
            "coords": mesh.coords, "dp_index": mesh.dp_index,
            "slots": (engine.batcher.lo, engine.batcher.lo
                      + engine.batcher.tokens.shape[0]),
            "peak": (torch.cuda.max_memory_allocated()
                     if dev.type == "cuda" else 0)}
        del engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    res["lm_serve"] = _dp_lm_serve(dev, cfg, sp, params, meshes[1, 2, 2],
                                   rows, forced)
    res["lm_serve"]["peak"] = (torch.cuda.max_memory_allocated()
                               if dev.type == "cuda" else 0)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def dp_shared_kernels(dev, gen, cfg):
    """nm_spmm_shared on the blocks of one layer over (1, 2, 2), rank r
    at "model" coordinate r for r = 0, 1 (q/k/v, w_gate, w_up: the
    columns F/2 with the rows whole; o_proj, w_down: the rows Kc/2,
    rebased by r K / 2), at build_lm_serve's rows a rank (LM_SERVE_ROWS
    over the 2 DP ranks: decode and prefill) and at B = 4 and
    LM_SERVE_ROWS' 128: within the phase-3 tolerance of the plain
    version; a column block's output bitwise the columns of the whole
    weight's output; the row blocks' outputs on their K blocks of one
    activation summed within 2 x that tolerance of the whole weight's
    plain product.  Rank 0's blocks are timed (cold L2) against the
    bound, the plain version and torch.matmul on the dense bf16 block.
    Returns (rank 0's rows, max abs err over both ranks)."""
    from repro_torch.core import bdwp
    from repro_torch.core.operand import SharedOp
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import nm_spmm_shared as KS
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import tp

    sp = SparsityConfig(n=2, m=8, method="bdwp")
    shape, dp = dict(zip(DP_AXES3, (1, 2, 2))), 2
    rows_a_rank = LM_SERVE_ROWS[0] // dp
    batches = sorted({rows_a_rank, rows_a_rank * LM_SERVE_ROWS[1], 4,
                      LM_SERVE_ROWS[0] * LM_SERVE_ROWS[1]})
    out_rows, worst = [], 0.0
    for name, k, f in arch_proj(cfg):
        row = name in ("o_proj", "w_down")
        w = torch.randn((k, f), generator=gen, device=dev).to(torch.bfloat16)
        vals, idx = bdwp.shared_ff_pack(w, sp)
        spec = (SharedOp(("model", None), ("model",)) if row
                else SharedOp((None, "model"), (None,)))
        blks = [tp.serve_blocks({"w": SharedOp(vals, idx, k)}, {"w": spec},
                                Mesh(shape, r))["w"] for r in range(2)]
        for b in batches:
            act_whole = torch.randn((b, k), generator=gen, device=dev).to(
                torch.bfloat16)
            whole_out = KS.nm_spmm_shared(act_whole, vals[None], idx[None])
            row_sum = 0
            for r, blk in enumerate(blks):
                kc_l, f_l = blk.vals.shape
                act = (act_whole[:, r * blk.k:(r + 1) * blk.k].contiguous()
                       if row else act_whole)
                got = KS.nm_spmm_shared(act, blk.vals[None], blk.idx[None])
                plain = ref.ref_nm_spmm_shared(act, blk.vals[None],
                                               blk.idx[None])
                scale = ref.ref_nm_spmm_shared(
                    act.abs(), blk.vals.abs()[None], blk.idx[None])
                col_bitwise = (None if row else bits_equal(
                    got, whole_out[:, r * f_l:(r + 1) * f_l].contiguous()))
                if row:
                    row_sum = row_sum + got
                torch.cuda.synchronize()
                err = (got - plain).abs()
                worst = max(worst, float(err.max()))
                label = (f"{name} rank {r} block ({blk.k}, {kc_l}, {f_l}) "
                         f"B={b}")
                check(float((err - TOL * scale).max()) <= 0,
                      f"dp serve nm_spmm_shared {label}: error above "
                      "tolerance")
                check(col_bitwise in (None, True), f"dp serve nm_spmm_shared "
                      f"{label}: not the whole weight's columns bit for bit")
                if r:
                    print(f"  {label:47s} max_abs_err={float(err.max()):.3e}"
                          + ("" if row else f"; the whole weight's columns "
                             f"bit for bit: {col_bitwise}"))
                    continue
                dense = (w[:blk.k] if row else
                         w[:, :f_l].contiguous())
                copies = max(2, -(-2 * L2_BYTES // (kc_l * f_l * 2)))
                sets = [(blk.vals.clone()[None], blk.idx.clone()[None])
                        for _ in range(copies)]
                dens = [dense.clone() for _ in range(max(2, -(
                    -2 * L2_BYTES // (dense.numel() * 2))))]
                t_k = time_ms(lambda i: KS.nm_spmm_shared(act, *sets[i]),
                              copies)
                t_p = time_ms(lambda i: ref.ref_nm_spmm_shared(act, *sets[i]),
                              copies, iters=10)
                t_l = time_ms(lambda i: torch.matmul(act, dens[i]), len(dens))
                t_b, by = shared_bound_ms(b, blk.k, kc_l, f_l)
                out_rows.append({"proj": name, "B": b, "K": blk.k, "Kc": kc_l,
                                 "F": f_l, "ms": t_k, "plain_ms": t_p,
                                 "library_ms": t_l, "bound_ms": t_b,
                                 "bound_by": by, "col_bitwise": col_bitwise,
                                 "max_abs_err": float(err.max())})
                print(f"  {label:47s} kernel={t_k:.4f} ms bound={t_b:.4f} ms "
                      f"({by}) plain={t_p:.4f} ms torch.matmul(dense bf16 "
                      f"block)={t_l:.4f} ms max_abs_err={float(err.max()):.3e}"
                      + ("" if row else f"; the whole weight's columns bit "
                         f"for bit: {col_bitwise}"))
                del sets, dens
            if row:
                scale = ref.ref_nm_spmm_shared(act_whole.abs(),
                                               vals.abs()[None], idx[None])
                sum_err = (row_sum - ref.ref_nm_spmm_shared(
                    act_whole, vals[None], idx[None])).abs()
                check(float((sum_err - 2 * TOL * scale).max()) <= 0,
                      f"dp serve nm_spmm_shared {name} B={b}: the row blocks' "
                      "outputs summed are not the whole weight's product")
                print(f"  {name} B={b}: the 2 row blocks' outputs summed, "
                      f"{float(sum_err.max()):.3e} from the whole weight's "
                      "plain product")
    for b in batches:
        rs = [r for r in out_rows if r["B"] == b]
        t = {key: sum(r[key] for r in rs)
             for key in ("ms", "library_ms", "bound_ms", "plain_ms")}
        print(f"  B={b} one layer of rank 0's blocks (7 projections): "
              f"{1e3 * t['ms']:.2f} us, bound {1e3 * t['bound_ms']:.2f} us, "
              f"plain {1e3 * t['plain_ms']:.1f} us, torch.matmul on the "
              f"dense blocks {1e3 * t['library_ms']:.2f} us")
    return out_rows, worst


def lm_serve_one_process(dev, seed, cfg, sp):
    """Phase 56 part 2's reference: phase 17's path at ``cfg``'s depth,
    the seed's weights ``pack_tree_shared`` layer by layer on the card,
    LM_SERVE_ROWS prompt rows from the seed prefilled, then
    LM_SERVE_STEPS greedy shared-cursor decode steps; the logits of each
    forward (fp32, host), the greedy tokens, and each "model" rank's
    shared blocks' fingerprint at (1, 2, 2) from plain slices."""
    from repro_torch.core import bdwp
    from repro_torch.kernels import nm_spmm_shared as KS
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer_lm as T
    from repro_torch.train import step as ST
    from repro_torch.train.checkpoint import state_fingerprint

    gen = T.generator(seed, dev)
    shell = T.init_shell(cfg, gen, device=dev, dtype=torch.bfloat16)
    params = bdwp.pack_tree_shared(shell, sp, device=dev)
    del shell
    params["blocks"] = [bdwp.pack_tree_shared({"blocks": blk}, sp,
                                              device=dev)["blocks"]
                        for blk in T.iter_blocks(cfg, gen, device=dev,
                                                 dtype=torch.bfloat16)]
    specs = ST.build_lm_serve(cfg, Mesh(dict(zip(DP_AXES3, (1, 2, 2)))), sp,
                              {}, packed=True).state_shardings
    fps = {r: state_fingerprint(shared_block_slices(params, specs, r, 2))
           for r in range(2)}
    b, s = LM_SERVE_ROWS
    rows = np.random.default_rng(seed + 56).integers(0, cfg.vocab, (b, s))
    torch.cuda.synchronize()
    KS.launches = 0
    t0 = time.perf_counter()
    lg, pre = ST.lm_prefill_step(params, {"tokens": torch.as_tensor(
        rows, device=dev)}, cfg=cfg, sp_cfg=sp)
    cache = seat_rows(T.init_lm_cache(cfg, b, s + LM_SERVE_STEPS,
                                      device=dev), pre, s)
    del pre
    logits = [lg[:, -1].float()]
    tokens = [torch.argmax(lg[:, -1, :cfg.vocab], -1)]
    for i in range(LM_SERVE_STEPS):
        lg, cache = ST.lm_decode_step(params, cache, tokens[-1][:, None],
                                      s + i, cfg=cfg, sp_cfg=sp,
                                      per_slot=False)
        logits.append(lg[:, -1].float())
        tokens.append(torch.argmax(lg[:, -1, :cfg.vocab], -1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = KS.launches
    check(launches == 7 * cfg.n_layers * (1 + LM_SERVE_STEPS),
          "dp serve one process: nm_spmm_shared launch count")
    del params, cache
    torch.cuda.empty_cache()
    return {"logits": torch.stack(logits).cpu(),
            "tokens": torch.stack(tokens).cpu(), "rows": rows,
            "fingerprints": fps, "wall_s": wall, "launches": launches}


def phase_dp_serve(dev, seed, cfg, handoff):
    """qwen3-8b at ``cfg``'s widths, 2:8: nm_spmm_shared at a rank's
    blocks; then on DP_RANKS processes on the one card (gloo) the
    engine (u4) at each of DP_MESHES against phase 55's one engine
    (``handoff``), and build_lm_serve(packed=True) at (1, 2, 2) against
    ``lm_serve_one_process``; see the module docstring, phase 56."""
    from repro_torch.core.sparsity import SparsityConfig

    sp = SparsityConfig(n=2, m=8, method="bdwp")
    gen = torch.Generator(device=dev).manual_seed(seed + 56)
    kernel_rows, kernel_err = dp_shared_kernels(dev, gen, cfg)
    torch.cuda.empty_cache()
    one = lm_serve_one_process(dev, seed, cfg, sp)
    forced = one["tokens"][:LM_SERVE_STEPS].numpy()

    import tempfile

    import torch.multiprocessing as mp

    out = tempfile.mkdtemp(prefix="dp_serve_")
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _dp_rank, args=(DP_RANKS, os.path.join(out, "store"), out, str(dev),
                        seed, cfg, handoff["prompts"], one["rows"], forced),
        nprocs=DP_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + TP_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"dp serve: the ranks did not end in {TP_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks_wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_RANKS)]
    shutil.rmtree(out, ignore_errors=True)

    per_fwd = packed_per_forward(cfg)
    solo, solo_log = handoff["streams"], handoff["log"]
    fps = handoff["fingerprints"]
    report = {"engines": {}, "lm_serve": {}, "ranks_wall_s": ranks_wall,
              "kernel_rows": kernel_rows, "kernel_err": kernel_err,
              "lm_serve_one_process": {k: one[k] for k in (
                  "wall_s", "launches", "fingerprints")}}
    for shape in DP_MESHES:
        model = shape[2]
        kv = 0 if cfg.n_kv % model == 0 else 2 * cfg.n_layers
        want_model = ({"all_reduces": 2 * cfg.n_layers, "embed_lookups": 1,
                       "gathers": 1 + kv} if model > 1 else
                      {"all_reduces": 0, "embed_lookups": 0, "gathers": 0})
        rows_out = {}
        for r, rk in enumerate(ranks):
            res = rk["engines"][shape]
            label = f"dp serve {shape} rank {r}"
            rst = res["stats"]
            fwd = rst["prefill_steps"] + rst["decode_steps"]
            check(res["compact"] == per_fwd
                  and res["compact_variants"]["vector"] == per_fwd,
                  f"{label}: nm_compact launches {res['compact']} "
                  f"{res['compact_variants']}")
            check(res["launches"] == per_fwd * fwd and fwd > 0,
                  f"{label}: nm_spmm launch count {res['launches']}")
            want_fp = (fps[res["coords"]["model"]] if model > 1
                       else fps["whole"])
            check(res["fingerprint"] == want_fp, f"{label}: its store is "
                  "not its blocks of the one-process store")
            check(res["streams"] == ranks[0]["engines"][shape]["streams"],
                  f"{label}: streams differ from rank 0's")
            for other in ranks:
                o = other["engines"][shape]
                if o["dp_index"] == res["dp_index"]:
                    check(all(bits_equal(a["logits"], b["logits"])
                              for a, b in zip(res["log"], o["log"])),
                          f"{label}: logits differ from its DP rank's")
            per_kind = {}
            for e in res["log"]:
                c = e["collectives"]
                want = dict(want_model, dp_gathers=int(
                    e["kind"] == "decode"), lane_shares=0)
                check(all(c[k] == v for k, v in want.items()),
                      f"{label}: collectives of a {e['kind']} step {c}, "
                      f"want {want}")
                per_kind.setdefault(e["kind"], []).append(c)
            coll = {kind: {k: sum(c[k] for c in cs) / len(cs)
                           for k in cs[0]} for kind, cs in per_kind.items()}
            worst, part = _tp_parting(solo_log, res["log"], label,
                                      res["slots"])
            check(worst <= TP_LOGIT_ATOL,
                  f"{label}: teacher-forced logits {worst:.3e} from the "
                  f"one-process logits, over {TP_LOGIT_ATOL}")
            if part is None:
                check(res["streams"] == solo, f"{label}: streams differ")
            else:
                print(f"  {label}: parts from the one-process streams at "
                      f"step {part['step']} ({part['kind']}, slot "
                      f"{part['slot']}), one-process top-two gap "
                      f"{part['top2_gap']:.3e}")
                check(part["top2_gap"] < TP_LOGIT_ATOL,
                      f"{label}: parted where the one-process top-two gap "
                      f"{part['top2_gap']:.3e} is not under {TP_LOGIT_ATOL}")
            row = {"coords": res["coords"], "slots": res["slots"],
                   "launches": res["launches"],
                   "compact_launches": res["compact"],
                   "compact_variants": res["compact_variants"],
                   "weight_bytes": res["store_bytes"],
                   "peak_bytes": res["peak"],
                   "ms_per_step": 1e3 * res["wall_s"] / rst["steps"],
                   "tok_per_s": rst["decoded_tokens"] / res["wall_s"],
                   "collectives_per_step": coll, "max_logit_gap": worst,
                   "parting": part, "stats": rst,
                   "streams_equal_one_process": res["streams"] == solo}
            rows_out[r] = row
            print(f"  {label} {res['coords']} slots {res['slots']}: weights "
                  f"{res['store_bytes'] / 2**30:.3f} GiB, peak "
                  f"{res['peak'] / 2**30:.2f} GiB, {row['ms_per_step']:.2f} "
                  f"ms a step, {row['tok_per_s']:.1f} tok/s (smoke "
                  f"readings); nm_spmm {res['launches']} (want "
                  f"{per_fwd * fwd}), nm_compact {res['compact']} "
                  f"{res['compact_variants']}; logit gap {worst:.3e} (limit "
                  f"{TP_LOGIT_ATOL}); streams equal the one-process streams: "
                  f"{row['streams_equal_one_process']}")
            for kind, c in coll.items():
                print(f"  {label} per {kind} step: {c['all_reduces']:.0f} "
                      f"all-reduces ({c['all_reduce_bytes']:.0f} B), "
                      f"{c['embed_lookups']:.0f} lookups, {c['gathers']:.0f}"
                      f" gathers ({c['gather_bytes']:.0f} B), "
                      f"{c['dp_gathers']:.0f} token gathers "
                      f"({c['dp_gather_bytes']:.0f} B)")
        report["engines"]["x".join(map(str, shape))] = rows_out

    want_launches = 7 * cfg.n_layers * (1 + LM_SERVE_STEPS)
    top2 = one["logits"][..., :cfg.vocab].topk(2, -1).values
    clear = (top2[..., 0] - top2[..., 1]) > TP_LOGIT_ATOL
    for r, rk in enumerate(ranks):
        res, label = rk["lm_serve"], f"lm_serve (1, 2, 2) rank {r}"
        model = r % 2
        check(res["launches"] == want_launches,
              f"{label}: nm_spmm_shared launches {res['launches']}, want "
              f"{want_launches}")
        check(res["compact"] == per_fwd
              and res["compact_variants"]["scalar"] == per_fwd,
              f"{label}: nm_compact launches {res['compact']} "
              f"{res['compact_variants']}")
        check(res["fingerprint"] == one["fingerprints"][model],
              f"{label}: its shared blocks (row blocks' rows + r K / M) are "
              "not the whole pack's")
        check(torch.equal(res["logits"], ranks[0]["lm_serve"]["logits"]),
              f"{label}: logits differ from rank 0's")
        gap = float((res["logits"] - one["logits"]).abs().max())
        check(gap <= TP_LOGIT_ATOL, f"{label}: logits {gap:.3e} from the "
              f"one-process shared serve, over {TP_LOGIT_ATOL}")
        mine = res["logits"][..., :cfg.vocab].argmax(-1)
        check(bool((mine == one["tokens"])[clear].all()),
              f"{label}: a token differs where the top-two gap is over "
              f"{TP_LOGIT_ATOL}")
        for i, c in enumerate(res["collectives"]):
            want = {"all_reduces": 2 * cfg.n_layers, "embed_lookups": 1,
                    "gathers": 1, "dp_gathers": 1}
            check(all(c[k] == v for k, v in want.items()),
                  f"{label}: collectives of forward {i} {c}, want {want}")
        fwd = len(res["collectives"])
        row = {"launches": res["launches"],
               "compact_launches": res["compact"],
               "compact_variants": res["compact_variants"],
               "max_logit_gap": gap, "rows": res["rows"],
               "weight_bytes": res["weight_bytes"], "peak_bytes": res["peak"],
               "ms_per_forward": 1e3 * res["wall_s"] / fwd,
               "tokens_equal_one_process": bool((mine == one["tokens"]).all()),
               "collectives_per_forward": {
                   k: sum(c[k] for c in res["collectives"]) / fwd
                   for k in res["collectives"][0]}}
        report["lm_serve"][r] = row
        print(f"  {label} rows {res['rows']}: shared blocks "
              f"{res['weight_bytes'] / 2**30:.3f} GiB, peak "
              f"{res['peak'] / 2**30:.2f} GiB; nm_spmm_shared "
              f"{res['launches']} (want {want_launches}), nm_compact "
              f"{res['compact']} {res['compact_variants']}; logits "
              f"{gap:.3e} from one process (limit {TP_LOGIT_ATOL}), every "
              f"token equal: {row['tokens_equal_one_process']}; "
              f"{row['ms_per_forward']:.2f} ms a forward (one process "
              f"{1e3 * one['wall_s'] / fwd:.2f}); per forward "
              f"{row['collectives_per_forward']}")
    card = card_line()
    print(f"  ranks' run {ranks_wall:.1f} s with start-up; {card}")
    report["card"] = card
    return report


def _leaf_at(tree, name):
    for key in name.split("/"):
        tree = tree[key]
    return tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the measured details here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    starts = []     # (phase, its start in the run's seconds), for --out

    def head(title):   # a phase's title, with the run's seconds so far
        t = time.perf_counter() - t_start
        starts.append((title.split("]")[0] + "]", t))
        print(f"{title}  (t = {t:.1f} s)")

    head("[1] card")
    card = card_line()
    print(f"  {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    head("[2] build")
    t0 = time.perf_counter()
    built = build.build_all()
    for name, info in built.items():
        print(f"  {name}: {info['seconds']:.1f} s")
        print_build_log(name, info["log"])
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    sass = {name: sass_counts(build.library_path(name), kernels)
            for name, kernels in SASS_KERNELS.items()}
    for name, per in sass.items():
        for label, c in per.items():
            print(f"  SASS {name} {label}: {c['total']} instructions, "
                  f"{c['integer']} integer, loads {c['loads']}, stores "
                  f"{c['stores']}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    head("[3] kernels vs plain versions")
    max_err = phase_kernels(dev, gen)
    head("[4] timing (cold L2)")
    rows = phase_timing(dev, gen)
    head("[5] SMOKE size: card vs CPU")
    phase_small(dev, SEED)
    from repro_torch.configs import qwen3_8b

    serve_cfg = dataclasses.replace(qwen3_8b.FULL, n_layers=SERVE_LAYERS)
    head(f"[6] serve qwen3-8b FULL widths ({SERVE_LAYERS} of 36 layers), "
         "packed 2:8 u4")
    serve = phase_serve(dev, SEED, serve_cfg)
    torch.cuda.empty_cache()
    head("[7] fused_update vs plain, and timing (cold L2)")
    upd_err, upd_rows, upd_layer = phase_update(dev, gen)
    head(f"[8] nm_spmm at training rows (B = {TRAIN_ROWS[0]} x "
          f"{TRAIN_ROWS[1]}, and one pod's rows of [14]), u8")
    spmm_err, spmm_rows, spmm_pod_rows = phase_spmm_train(dev, gen)
    head("[9] SMOKE-size training: card vs CPU")
    phase_train_small(dev, SEED)
    head("[10] train qwen3-8b TRAIN (full width, 8 layers), 2:8 bdwp, "
          "packed")
    train = phase_train(dev, SEED)
    torch.cuda.empty_cache()
    head("[11] grad_compress and grad_decompress_mean vs plain, and timing")
    sync_err, sync_rows = phase_sync_kernels(dev, gen)
    torch.cuda.empty_cache()
    head("[12] cross_pod_sync alone at qwen3-8b TRAIN_SYNC leaf shapes, "
          "P = 2")
    sync_alone = phase_sync_alone(dev, SEED)
    torch.cuda.empty_cache()
    head("[13] SMOKE compressed training (P = 2): card vs CPU")
    phase_train_sync_small(dev, SEED)
    head("[14] train qwen3-8b TRAIN_SYNC (full width, 4 layers), 2 pods, "
          "compressed sync, 2:8 bdwp, packed")
    train_sync = phase_train_sync(dev, SEED)
    torch.cuda.empty_cache()
    head("[15] nm_compact and nm_spmm_shared vs plain, and timing (cold L2)")
    compact_err, compact_rows = phase_compact(dev, gen)
    shared_err, shared_rows = phase_shared(dev, gen)
    torch.cuda.empty_cache()
    head("[16] SMOKE shared-pattern serving: card vs CPU")
    phase_shared_small(dev, SEED)
    head(f"[17] serve qwen3-8b FULL widths ({SERVE_LAYERS} of 36 layers), "
         "shared-pattern 2:8 (reduced K)")
    shared_serve = phase_shared_serve(dev, SEED, serve_cfg)
    torch.cuda.empty_cache()
    head("[18] paper models' kernels: nm_spmm at ViT rows, fused_update at "
          "the sites' views")
    paper_spmm_err, paper_spmm_rows, paper_upd_err, paper_upd_rows = \
        phase_paper_kernels(dev, gen)
    torch.cuda.empty_cache()
    head("[19] paper models, small: card vs CPU")
    phase_paper_small(dev, SEED)
    head("[20] train ResNet9, VGG19 and ViT at Table I's widths and batch, "
          "2:8 bdwp, packed")
    paper = phase_paper_train(dev, SEED)
    torch.cuda.empty_cache()
    head("[21] SMOKE-size training, every method on both dataflows, shared "
          "and transposable masks, the legacy compressed step; legacy "
          "ResNet9: card vs CPU")
    _, legacy_sync = phase_dataflow_small(dev, SEED)
    flows = {}
    for num, flow in ((22, "transposable"), (23, "shared"), (24, "legacy")):
        torch.cuda.empty_cache()
        head(f"[{num}] train qwen3-8b TRAIN (full width, {FLOW_LAYERS} "
              "layers), 2:8 "
              f"bdwp, {flow}" + (", packed" if flow == "transposable" else "")
              + (", pre-generated, unpacked" if flow == "shared" else "")
              + (" (pregen=False)" if flow == "legacy" else ""))
        flows[flow] = phase_train_flow(dev, SEED, flow)
    torch.cuda.empty_cache()
    head("[25] the paper's models on the legacy dataflow at Table I's "
          "widths and batch")
    paper_legacy = phase_paper_legacy(dev, SEED)
    torch.cuda.empty_cache()
    head("[26] Fig. 4: ResNet9 x five methods x the reference's seeds, 120 "
          "steps, against its committed curves; Table I's lr")
    fig4 = phase_fig4(dev)
    head("[27] the new archs' kernels: nm_spmm, fused_update and "
          "nm_compact at their projection shapes")
    arch_err, arch_rows = phase_arch_kernels(dev, gen)
    head("[28] the new archs at SMOKE size: card vs CPU")
    phase_arch_small(dev, SEED)
    arch_train, arch_serve = {}, {}
    for arch_id in ARCH_IDS:
        torch.cuda.empty_cache()
        b, text, prefix = ARCH_TRAIN_ROWS[arch_id]
        cfg = arch_module(arch_id).TRAIN
        head(f"[29] train {arch_id} TRAIN (full width, {cfg.n_layers} of "
              f"{arch_module(arch_id).FULL.n_layers} layers), 2:8 bdwp, "
              f"packed, {b} x ({f'{prefix} prefix + ' if prefix else ''}"
              f"{text}) tokens")
        arch_train[arch_id] = phase_train(dev, SEED, cfg, (b, text), prefix)
    for arch_id in ARCH_IDS:
        torch.cuda.empty_cache()
        full = arch_module(arch_id).FULL.n_layers
        head(f"[30] serve {arch_id} FULL widths ("
              f"{ARCH_SERVE_LAYERS.get(arch_id, full)} of {full} layers), "
              "packed 2:8 u4")
        arch_serve[arch_id] = phase_arch_serve(dev, SEED, arch_id)
    torch.cuda.empty_cache()
    head("[31] granite-moe kernels: nm_spmm on the 32-expert stacks in one "
          "launch, one layer's grouped fused_update, nm_spmm and nm_compact "
          "at the attention projections")
    (moe_err, moe_rows, moe_upd_err, moe_upd, arch_rows[MOE_ARCH],
     moe_attn_err) = phase_moe_kernels(dev, gen)
    head("[32] granite-moe SMOKE: card vs CPU")
    moe_small = phase_moe_small(dev, SEED)
    torch.cuda.empty_cache()
    from repro_torch.configs import granite_moe_1b

    moe_cfg = dataclasses.replace(granite_moe_1b.TRAIN, n_layers=MOE_LAYERS)
    head(f"[33] train {MOE_ARCH} TRAIN (full width, {moe_cfg.n_layers} of "
          f"{granite_moe_1b.FULL.n_layers} layers), 2:8 bdwp, packed, "
          f"{MOE_TRAIN_ROWS[0]} x {MOE_TRAIN_ROWS[1]} tokens")
    moe_train = phase_train(dev, SEED, moe_cfg, MOE_TRAIN_ROWS)
    torch.cuda.empty_cache()
    head(f"[34] serve {MOE_ARCH} FULL widths ({MOE_LAYERS} of 24 layers), "
         "attention packed 2:8 u4, experts masked")
    moe_serve = phase_moe_serve(dev, SEED, dataclasses.replace(
        granite_moe_1b.FULL, n_layers=MOE_LAYERS))
    torch.cuda.empty_cache()
    head("[35] deepseek-v2-lite kernels: nm_spmm on the 64-expert stacks and "
          "the MLA, prelude and shared-expert shapes, one MoE layer's "
          "grouped fused_update, nm_compact")
    (ds_err, ds_rows, ds_upd_err, ds_upd, arch_rows[DS_ARCH],
     ds_proj_err, ds_pack_rows, ds_pack) = phase_deepseek_kernels(dev, gen)
    torch.cuda.empty_cache()
    head("[36] deepseek-v2-lite SMOKE: card vs CPU")
    ds_small = phase_moe_small(dev, SEED, DS_ARCH, DS_SMALL_ATOL,
                               DS_PACKED_STEP_ATOL, cursor=True)
    torch.cuda.empty_cache()
    from repro_torch.configs import deepseek_v2_lite

    ds_cfg = deepseek_v2_lite.TRAIN
    head(f"[37] train {DS_ARCH} TRAIN (full width, the prelude and "
          f"{ds_cfg.n_blocks} of {deepseek_v2_lite.FULL.n_blocks} MoE "
          f"layers), 2:8 bdwp, packed, {DS_TRAIN_ROWS[0]} x "
          f"{DS_TRAIN_ROWS[1]} tokens")
    ds_train = phase_train(dev, SEED, ds_cfg, DS_TRAIN_ROWS)
    torch.cuda.empty_cache()
    head(f"[38] serve {DS_ARCH} FULL widths ({DS_SERVE_LAYERS} of 27 "
          "layers), MLA and the prelude packed "
          "2:8 u4, experts masked")
    ds_serve = phase_moe_serve(dev, SEED, dataclasses.replace(
        deepseek_v2_lite.FULL, n_layers=DS_SERVE_LAYERS), DS_SERVE_LENS,
        DS_SERVE_NEW)
    torch.cuda.empty_cache()
    head("[39] mamba2-370m and hymba-1.5b kernels: nm_spmm at their sites "
          "(decode and training rows), one layer's grouped fused_update, "
          "nm_compact and the FULL element packs")
    ssm_err, ssm_rows = phase_ssm_kernels(dev, gen)
    for arch_id in SSM_ARCHS:
        arch_rows[arch_id] = ssm_rows[arch_id]["spmm"]
    torch.cuda.empty_cache()
    head("[40] mamba2 and hymba SMOKE: card vs CPU")
    ssm_small = phase_ssm_small(dev, SEED)
    ssm_train, ssm_serve = {}, {}
    for arch_id in SSM_ARCHS:
        torch.cuda.empty_cache()
        full = arch_module(arch_id).TRAIN
        cfg = dataclasses.replace(full, n_layers=SSM_LAYERS[arch_id])
        head(f"[41] train {arch_id} TRAIN (full width, {cfg.n_layers} of "
              f"{full.n_layers} layers), 2:8 bdwp, packed, "
              f"{SSM_TRAIN_ROWS[0]} x {SSM_TRAIN_ROWS[1]} tokens")
        ssm_train[arch_id] = phase_train(dev, SEED, cfg, SSM_TRAIN_ROWS)
    for arch_id in SSM_ARCHS:
        torch.cuda.empty_cache()
        full = arch_module(arch_id).FULL
        cfg = dataclasses.replace(full, n_layers=SSM_LAYERS[arch_id])
        head(f"[42] serve {arch_id} FULL widths ({cfg.n_layers} of "
              f"{full.n_layers} layers), packed 2:8 u4")
        ssm_serve[arch_id] = phase_serve(dev, SEED, cfg)
    torch.cuda.empty_cache()
    head("[43] whisper-large-v3 kernels: nm_spmm at its sites (decode rows, "
         "the TRAIN step's encoder rows, a decode step's cross K/V), one "
         "decoder layer's and a 512-site grouped fused_update, nm_compact "
         "and the FULL element pack")
    whisper_err, whisper_rows = phase_whisper_kernels(dev, gen)
    torch.cuda.empty_cache()
    head("[44] whisper-large-v3 SMOKE: card vs CPU")
    whisper_small = phase_whisper_small(dev, SEED)
    torch.cuda.empty_cache()
    w_rows, w_frames, w_tok = WHISPER_TRAIN_ROWS
    from repro_torch.configs import whisper_large_v3

    w_enc, w_dec = WHISPER_TRAIN_LAYERS
    head(f"[45] train {WHISPER} TRAIN (full width, {w_enc} + {w_dec} of 32 "
         f"+ 32 layers), 2:8 bdwp, packed, {w_rows} x ({w_frames} frames, "
         f"{w_tok} tokens)")
    whisper_train = phase_whisper_train(dev, SEED, dataclasses.replace(
        whisper_large_v3.TRAIN, n_enc_layers=w_enc, n_layers=w_dec))
    torch.cuda.empty_cache()
    head(f"[46] serve {WHISPER} FULL ({WHISPER_SERVE_LAYERS} + "
         f"{WHISPER_SERVE_LAYERS} of 32 + 32 layers), packed 2:8 u4, "
         f"{WHISPER_SERVE_ROWS} rows, {WHISPER_DECODE_STEPS} shared-cursor "
         "decode steps; B = 1 against B = 4")
    whisper_serve = phase_whisper_serve(dev, SEED, dataclasses.replace(
        whisper_large_v3.FULL, n_enc_layers=WHISPER_SERVE_LAYERS,
        n_layers=WHISPER_SERVE_LAYERS))
    torch.cuda.empty_cache()
    head("[47] grad_compress and grad_decompress_mean at the new archs' "
         "leaves: granite's and deepseek's expert stacks, deepseek's "
         "prelude, mamba2's and hymba's SSD leaves")
    new_sync_err, new_sync_rows = phase_sync_new_leaves(dev, gen)
    torch.cuda.empty_cache()
    head("[48] mvue on the card: card == CPU given the uniforms, "
         "unbiasedness")
    mvue = phase_mvue(dev, SEED)
    torch.cuda.empty_cache()
    head(f"[49] train granite-moe-1b-a400m TRAIN (full width, "
         f"{SYNC_MOE_LAYERS} of 24 layers), 2 pods on one card, topk "
         f"compressed sync, 2:8 bdwp, packed, {MOE_TRAIN_ROWS[0]} x "
         f"{MOE_TRAIN_ROWS[1]} tokens")
    granite_sync = phase_train_granite_sync(dev, SEED)
    torch.cuda.empty_cache()
    head(f"[50] the process form: [49] in two processes on the one card "
         f"through the launcher, {SYNC_PROC_STEPS} steps")
    granite_procs = phase_train_granite_procs(dev, SEED, granite_sync)
    torch.cuda.empty_cache()
    head(f"[51] FSDP: qwen3-8b TRAIN (full width, {FSDP_LAYERS} of 36 "
         "layers) through the launcher's --mesh data=2, two processes on the "
         f"one card, {FSDP_STEPS} steps of {FSDP_ROWS[0]} x {FSDP_ROWS[1]} "
         "tokens; a rank's update of its blocks")
    shard_upd = phase_fsdp_update(dev, gen)
    fsdp = phase_fsdp_train(dev, SEED, during=lambda: Background(
        lambda: phase_ckpt_reshard(dev, SEED)))
    torch.cuda.empty_cache()
    head(f"[52] pod x data: granite-moe-1b-a400m (full width, "
         f"{POD_DATA_LAYERS} of 24 layers), --mesh pod=2,data=2 --compress, "
         f"four processes on the one card, {POD_DATA_STEPS} steps")
    pod_sync = phase_pod_data_sync(dev, gen)
    pod_data = phase_pod_data_train(dev, SEED, granite_sync)
    del granite_sync["masters"]
    torch.cuda.empty_cache()
    head("[53] checkpoints across meshes: data=2 -> 1 -> 2 and "
         "restore_with_pregen, through the launcher (run beside [51]'s "
         "second run)")
    reshard = fsdp.pop("during")
    print(reshard["summary"])
    torch.cuda.empty_cache()
    head(f"[54] fleet: qwen3-8b FULL widths ({SERVE_LAYERS} of 36 layers), "
         "packed 2:8 u4, one store; 1 replica, 2 under three routers, "
         "disaggregated 1 + 2, AsyncFrontend")
    fleet = phase_fleet(dev, SEED, serve_cfg)
    torch.cuda.empty_cache()
    head(f"[55] tp serve: qwen3-8b FULL widths ({SERVE_LAYERS} of 36 layers),"
         f" packed 2:8 u4, over model = {TP_RANKS} ranks (processes on the "
         "one card, gloo) against one engine")
    tp_serve = phase_tp_serve(dev, SEED, serve_cfg)
    torch.cuda.empty_cache()
    head(f"[56] dp serve: qwen3-8b FULL widths ({SERVE_LAYERS} of 36 layers),"
         f" 2:8, {DP_RANKS} processes on the one card (gloo): the engine (u4)"
         " at (pod, data, model) = " + " and ".join(map(str, DP_MESHES))
         + ", build_lm_serve (shared-packed) at (1, 2, 2)")
    dp_serve = phase_dp_serve(dev, SEED, serve_cfg, tp_serve.pop("handoff"))

    def summed(rs, at, launches, by_path, err):
        return {"launches": launches, "launches_by_path": by_path,
                "max_abs_err": err, "ms": sum(r["ms"] for r in rs),
                "plain_ms": sum(r["plain_ms"] for r in rs),
                "bound_ms": sum(r["bound_ms"] for r in rs),
                "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                           for r in rs) else "operations",
                "library_ms": None if any(r["library_ms"] is None
                                          for r in rs)
                else sum(r["library_ms"] for r in rs), "at": at}

    decode = [r for r in rows if r["B"] == 4]
    flow_paths = {f"train_{flow}": r["launches"]
                  for flow, r in flows.items()}
    flow_paths["paper_legacy"] = {
        k: sum(r["launches"][k] for r in paper_legacy.values())
        for k in ("nm_spmm", "fused_update")}
    spmm_paths = {"serve": serve["launches"],
                  "train": train["launches"]["nm_spmm"],
                  "train_sync": train_sync["launches"]["nm_spmm"],
                  "paper_train": sum(r["launches"]["nm_spmm"]
                                     for r in paper.values()),
                  **{k: v["nm_spmm"] for k, v in flow_paths.items()},
                  **{f"train_{a}": r["launches"]["nm_spmm"]
                     for a, r in arch_train.items()},
                  **{f"serve_{a}": r["launches"] + (
                      r["then"]["launches"] if r.get("then") else 0)
                     for a, r in arch_serve.items()},
                  "train_granite": moe_train["launches"]["nm_spmm"],
                  "serve_granite": moe_serve["launches"],
                  "train_deepseek": ds_train["launches"]["nm_spmm"],
                  "serve_deepseek": ds_serve["launches"],
                  **{f"train_{a.split('-')[0]}": r["launches"]["nm_spmm"]
                     for a, r in ssm_train.items()},
                  **{f"serve_{a.split('-')[0]}": r["launches"]
                     for a, r in ssm_serve.items()},
                  "train_whisper": whisper_train["launches"]["nm_spmm"],
                  "serve_whisper": whisper_serve["batched_launches"],
                  "train_granite_sync": granite_sync["launches"]["nm_spmm"],
                  **{f"train_granite_procs/rank{k}": v["nm_spmm"]
                     for k, v in granite_procs["launches"].items()},
                  **{f"train_fsdp/rank{k}": v["launches"]["nm_spmm"]
                     for k, v in fsdp["ranks"].items()},
                  **{f"train_pod_data/rank{k}": v["launches"]["nm_spmm"]
                     for k, v in pod_data["ranks"].items()},
                  "fleet": fleet["launches"],
                  **{f"tp_serve/rank{k}": v["launches"]
                     for k, v in tp_serve["ranks"].items()},
                  **{f"dp_serve/{m}/rank{k}": v["launches"]
                     for m, rs in dp_serve["engines"].items()
                     for k, v in rs.items()}}
    upd_paths, upd_sites = ({
        "train": train["launches"][key],
        "train_sync": train_sync["launches"][key],
        "paper_train": sum(r["launches"][key] for r in paper.values()),
        **{f"train_{a}": r["launches"][key] for a, r in arch_train.items()},
        "train_granite": moe_train["launches"][key],
        "train_deepseek": ds_train["launches"][key],
        **{f"train_{a.split('-')[0]}": r["launches"][key]
           for a, r in ssm_train.items()},
        "train_whisper": whisper_train["launches"][key],
        "train_granite_sync": granite_sync["launches"][key]}
        for key in ("fused_update", "fused_update_sites"))
    upd_paths.update({f"train_granite_procs/rank{k}": v["fused_update"]
                      for k, v in granite_procs["launches"].items()})
    for path, run in (("train_fsdp", fsdp), ("train_pod_data", pod_data)):
        upd_paths.update({f"{path}/rank{k}": v["launches"]["fused_update"]
                          for k, v in run["ranks"].items()})
    upd_paths.update({k: v["fused_update"] for k, v in flow_paths.items()})
    compact_paths = {"serve": serve["compact_launches"],
                     "shared_serve": shared_serve["compact_launches"],
                     **{f"serve_{a}": r["compact_launches"]
                        for a, r in arch_serve.items()},
                     "serve_granite": moe_serve["compact_launches"],
                     "serve_deepseek": ds_serve["compact_launches"],
                     **{f"serve_{a.split('-')[0]}": r["compact_launches"]
                        for a, r in ssm_serve.items()},
                     "serve_whisper": whisper_serve["compact_launches"],
                     "fleet": fleet["compact_launches"],
                     **{f"tp_serve/rank{k}": v["compact_launches"]
                        for k, v in tp_serve["ranks"].items()},
                     **{f"dp_serve/{m}/rank{k}": v["compact_launches"]
                        for m, rs in dp_serve["engines"].items()
                        for k, v in rs.items()},
                     **{f"lm_serve/rank{k}": v["compact_launches"]
                        for k, v in dp_serve["lm_serve"].items()}}
    shared_paths = {"shared_serve": shared_serve["launches"],
                    **{f"lm_serve/rank{k}": v["launches"]
                       for k, v in dp_serve["lm_serve"].items()}}
    shared_decode = [r for r in shared_rows if r["B"] == 4]
    shared_prefill = [r for r in shared_rows if r["B"] != 4]
    sync_at = {(r["leaf"], r["dtype"]): r for r in sync_rows}

    def sync_row(name, at):
        r = sync_at["w_gate", "bf16"][name]
        by_path = {"train_sync": train_sync["launches"][name],
                   "legacy_sync_small": legacy_sync[name],
                   "train_granite_sync": granite_sync["launches"][name],
                   **{f"train_granite_procs/rank{k}": v[name]
                      for k, v in granite_procs["launches"].items()},
                   **{f"train_pod_data/rank{k}": v["launches"][name]
                      for k, v in pod_data["ranks"].items()}}
        if name == "grad_decompress_mean":
            by_path["mvue_sync"] = mvue["decompress_launches"]
        return dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/grad_compress.cu",
            replaces="src/repro/kernels/grad_compress.py:"
                     + ("61" if name == "grad_compress" else "117"),
            launches=sum(by_path.values()), launches_by_path=by_path,
            launches_vector_variant=train_sync["launches"][f"{name}/vector"],
            max_abs_err=max(sync_err, new_sync_err), ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by="bytes", library_ms=None, at=at,
            rank_blocks=dict(
                pod_sync, at="phase 52: one data rank's blocks of "
                "granite's 6-layer gradients, both pods in one tensor, "
                "bitwise the slice of the whole sync; ms on the host clock"),
            embed_leaf=sync_at["embed", "bf16"][name],
            bucket=sync_at["bucket", "bf16"][name],
            new_arch_leaves=[dict(
                at=f"{x['arch']} {x['leaf']} ({x['P']}, {x['K']}) "
                   f"{x['dtype']}", bound_by="bytes", library_ms=None,
                **x[name]) for x in new_sync_rows])
    kernels = [dict(
        name="nm_spmm", route="cuda",
        source="src/repro_torch/kernels/csrc/nm_spmm.cu",
        replaces="src/repro/kernels/nm_spmm.py:71",
        **summed(decode, "one decode layer: the 7 projections at B=4, 2:8 "
                 "u4, summed", sum(spmm_paths.values()), spmm_paths,
                 max(max_err, spmm_err, paper_spmm_err,
                     arch_err["nm_spmm"], moe_attn_err, ds_err,
                     ds_proj_err, ssm_err["nm_spmm"],
                     whisper_err["nm_spmm"])),
        arch_layers={a: {str(b): {key: sum(r[key] for r in rs
                                           if r["B"] == b)
                                  for key in ("ms", "library_ms", "bound_ms")}
                         for b in sorted({r["B"] for r in rs})}
                     for a, rs in arch_rows.items()},
        ssm_train_rows={a: dict(summed(
            [r for r in ssm_rows[a]["spmm"] if r["B"] != 4],
            f"one {a} layer's {len(ssm_rows[a]['spmm']) // 2} sites at "
            f"B={SSM_TRAIN_ROWS[0] * SSM_TRAIN_ROWS[1]}, 2:8 u8, summed; "
            "library: torch.matmul on the dense bf16 weights",
            spmm_paths[f"train_{a.split('-')[0]}"],
            {f"train_{a.split('-')[0]}":
             spmm_paths[f"train_{a.split('-')[0]}"]}, ssm_err["nm_spmm"]))
            for a in SSM_ARCHS},
        whisper_rows={str(b): summed(
            [r for r in whisper_rows["spmm"] if r["B"] == b],
            f"whisper-large-v3's cases at B={b}, summed: "
            + ", ".join(f"{r['proj']} {r['K']}x{r['F']} u{r['idx_bits']}"
                        for r in whisper_rows["spmm"] if r["B"] == b)
            + "; library: torch.matmul on the dense bf16 weights",
            spmm_paths["train_whisper" if b == w_rows * w_frames
                       else "serve_whisper"],
            {k: spmm_paths[k] for k in ("train_whisper", "serve_whisper")},
            whisper_err["nm_spmm"])
            for b in sorted({r["B"] for r in whisper_rows["spmm"]})},
        tp_rank_block_rows=summed(
            tp_serve["spmm_rows"], "one decode layer of one rank's blocks "
            "at model = 2: the 7 projections at B=4, 2:8 u4, summed (q, k, "
            "v, w_gate, w_up F/2; o_proj, w_down K/2); library: "
            "torch.matmul on the dense bf16 block", sum(
                v["launches"] for v in tp_serve["ranks"].values()),
            {f"tp_serve/rank{k}": v["launches"]
             for k, v in tp_serve["ranks"].items()}, tp_serve["spmm_err"]),
        train_rows=summed(spmm_rows, "one training layer's forward: the 7 "
                          "projections at B=2048, 2:8 u8, summed",
                          spmm_paths["train"], {"train": spmm_paths["train"]},
                          spmm_err),
        vit_rows=summed(paper_spmm_rows, "one ViT block's forward at Table "
                        f"I's batch: the 6 linears at B={paper_spmm_rows[0]['B']}"
                        ", 2:8 u8, summed", spmm_paths["paper_train"],
                        {"paper_train": spmm_paths["paper_train"]},
                        paper_spmm_err),
        expert_rows=dict(summed(
            moe_rows[:2], "one granite layer's three expert stacks in the "
            "forward: E=32 x 1280 rows, w_gate and w_up (1024 -> 512) and "
            "w_down (512 -> 1024), one stacked launch each, 2:8 u8 "
            "(w_gate/w_up counted twice); library: torch.bmm on the dense "
            "bf16 stacks", spmm_paths["train_granite"],
            {"train_granite": spmm_paths["train_granite"]}, moe_err),
            ms=2 * moe_rows[0]["ms"] + moe_rows[1]["ms"],
            plain_ms=2 * moe_rows[0]["plain_ms"] + moe_rows[1]["plain_ms"],
            bound_ms=2 * moe_rows[0]["bound_ms"] + moe_rows[1]["bound_ms"],
            library_ms=2 * moe_rows[0]["library_ms"]
            + moe_rows[1]["library_ms"],
            separate_ms=2 * moe_rows[0]["separate_ms"]
            + moe_rows[1]["separate_ms"], cases=moe_rows),
        deepseek_expert_rows=dict(summed(
            ds_rows, "one deepseek MoE layer's three expert stacks in the "
            "forward: E=64 x 480 rows, w_gate and w_up (2048 -> 1408) and "
            "w_down (1408 -> 2048), one stacked launch each, 2:8 u8 "
            "(w_gate/w_up counted twice); library: torch.bmm on the dense "
            "bf16 stacks", spmm_paths["train_deepseek"],
            {"train_deepseek": spmm_paths["train_deepseek"]}, ds_err),
            **{key: 2 * ds_rows[0][key] + ds_rows[1][key]
               for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                           "separate_ms")}, cases=ds_rows)),
        dict(name="fused_update", route="cuda",
             source="src/repro_torch/kernels/csrc/fused_update.cu",
             replaces="src/repro/kernels/fused_update.py:73",
             launches=sum(upd_paths.values()), launches_by_path=upd_paths,
             sites_by_path=upd_sites,
             max_abs_err=max(upd_err, paper_upd_err, arch_err["fused_update"],
                             moe_upd_err, ds_upd_err,
                             ssm_err["fused_update"],
                             whisper_err["fused_update"]),
             ms=upd_layer["ms"], plain_ms=upd_layer["plain_ms"],
             bound_ms=upd_layer["bound_ms"], bound_by="bytes",
             library_ms=None, singles_ms=upd_layer["singles_ms"],
             at="one layer's update as the step launches it: the 7 "
                "projections in one grouped launch, bf16 g, 2:8 bdwp (BP "
                "operand and FF mask written), 21.75 B/element",
             paper_steps={name: dict(
                 at=f"one {name} step's update: its {r['sites']} sites' "
                    "(H*W*I, O) or (K, F) views in one grouped launch, 2:8 "
                    "bdwp",
                 launches=paper[name]["launches"]["fused_update"],
                 ms=r["ms"], singles_ms=r["singles_ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by="bytes", library_ms=None)
                 for name, r in paper_upd_rows.items()},
             granite_layer=dict(
                 moe_upd, at="one granite layer's 7 sites (4 attention, 3 "
                 "expert stacks' (E*K, F) views) in one grouped launch, 2:8 "
                 "bdwp", launches=moe_train["launches"]["fused_update"]),
             deepseek_layer=dict(
                 ds_upd, at="one deepseek MoE layer's 11 sites (5 MLA "
                 "projections, 3 expert stacks' (E*K, F) views, 3 shared-"
                 "expert matrices) in one grouped launch, 2:8 bdwp",
                 launches=ds_train["launches"]["fused_update"]),
             ssm_layers={a: dict(
                 ssm_rows[a]["update"], at=f"one {a} layer's "
                 f"{ssm_rows[a]['update']['sites']} sites in one grouped "
                 "launch, 2:8 bdwp",
                 launches=ssm_train[a]["launches"]["fused_update"])
                 for a in SSM_ARCHS},
             rank_blocks=dict(
                 shard_upd, at="phase 51: rank 0's 7 block sites of one "
                 "qwen3-8b layer at data=2 (rows K/2; columns F/2 of o_proj "
                 "and w_down) in one grouped launch, 2:8 bdwp",
                 launches=sum(v["launches"]["fused_update"]
                              for v in fsdp["ranks"].values())),
             whisper_layer=dict(
                 whisper_rows["update"], at="one whisper decoder layer's 10 "
                 "sites in one grouped launch, 2:8 bdwp",
                 launches=whisper_train["launches"]["fused_update"],
                 step_sites=whisper_train["launches_per_step"][0][2],
                 step_elements=whisper_train["site_elements"])),
        sync_row("grad_compress", "one leaf, as the sync launches it: a "
                 "layer's w_gate, (2, 50331648) bf16 gradient rows + fp32 "
                 "residual columns, 2:8, vector variant"),
        sync_row("grad_decompress_mean", "one leaf: w_gate's (2, 12582912) "
                 "packed payload rows -> 50331648 bf16 means, 2:8, vector "
                 "variant"),
        dict(name="nm_compact", route="cuda",
             source="src/repro_torch/kernels/csrc/nm_compact.cu",
             replaces="src/repro/kernels/nm_compact.py:77",
             **summed(compact_rows, "one layer's element pack: the 7 "
                      "projections, bf16 (K, F) read as (F, K) views, 2:8 "
                      "u4, summed, vector variant", sum(
                          compact_paths.values()), compact_paths,
                      compact_err),
             launches_by_variant={
                 "serve": serve["compact_variants"],
                 "shared_serve": shared_serve["compact_variants"],
                 **{f"serve_{a}": r["compact_variants"]
                    for a, r in arch_serve.items()},
                 "serve_granite": moe_serve["compact_variants"],
                 "serve_deepseek": ds_serve["compact_variants"],
                 **{f"serve_{a.split('-')[0]}": r["compact_variants"]
                    for a, r in ssm_serve.items()},
                 "serve_whisper": whisper_serve["compact_variants"],
                 "fleet": fleet["compact_variants"],
                 **{f"tp_serve/rank{k}": v["compact_variants"]
                    for k, v in tp_serve["ranks"].items()},
                 **{f"dp_serve/{m}/rank{k}": v["compact_variants"]
                    for m, rs in dp_serve["engines"].items()
                    for k, v in rs.items()},
                 **{f"lm_serve/rank{k}": v["compact_variants"]
                    for k, v in dp_serve["lm_serve"].items()}},
             **{key: sum(r[key] for r in compact_rows)
                for key in ("scalar_ms", "u8_ms", "u8_bound_ms")},
             deepseek_pack=dict(
                 ds_pack, at="deepseek FULL's element pack (27 layers): 84 "
                 "bf16 (K, F) weights read as (F, K) views, 2:8 u4, vector "
                 "variant, summed from the six shapes; launches: phase "
                 "38's pack at 9 layers", bound_by="bytes",
                 library_ms=None,
                 launches=ds_serve["compact_launches"], cases=ds_pack_rows),
             ssm_packs={a: dict(
                 ssm_rows[a]["pack"], at=f"{a} FULL's element pack, 2:8 "
                 "u4, vector variant, summed from its shapes",
                 bound_by="bytes", library_ms=None,
                 launches=ssm_serve[a]["compact_launches"],
                 cases=ssm_rows[a]["pack_rows"]) for a in SSM_ARCHS},
             tp_rank_block_pack=dict(
                 tp_serve["pack_total"], at="one rank's element pack of its "
                 "blocks of qwen3-8b at model = 2, 9 layers: 63 bf16 (K, F) "
                 "blocks read as (F, K) views, 2:8 u4, vector variant, "
                 "summed from the seven shapes", bound_by="bytes",
                 library_ms=None, launches=sum(
                     v["compact_launches"]
                     for v in tp_serve["ranks"].values()),
                 cases=tp_serve["pack_rows"]),
             whisper_pack=dict(
                 whisper_rows["pack"], at="whisper-large-v3 FULL's element "
                 "pack, 512 weights, 2:8 u4, vector variant, summed from its "
                 "three shapes", bound_by="bytes", library_ms=None,
                 launches=whisper_serve["compact_launches"],
                 cases=whisper_rows["pack_rows"])),
        dict(name="nm_spmm_shared", route="cuda",
             source="src/repro_torch/kernels/csrc/nm_spmm_shared.cu",
             replaces="src/repro/kernels/nm_spmm_shared.py:104",
             **summed(shared_decode, "one decode layer: the 7 projections at "
                      "B=4, 2:8 shared pattern, one tile (TF = F), summed",
                      sum(shared_paths.values()), shared_paths,
                      max(shared_err, dp_serve["kernel_err"])),
             prefill_rows=summed(
                 shared_prefill, "one prefill layer: the 7 projections at "
                 f"B={PREFILL_ROWS[0] * PREFILL_ROWS[1]}, summed",
                 shared_serve["launches"],
                 {"shared_serve": shared_serve["launches"]}, shared_err),
             **{f"tp_rank_block_rows_b{b}": summed(
                 [r for r in dp_serve["kernel_rows"] if r["B"] == b],
                 f"one layer of rank 0's blocks at (1, 2, 2) at B={b} "
                 f"({LM_SERVE_ROWS[0] // 2} and "
                 f"{LM_SERVE_ROWS[0] // 2 * LM_SERVE_ROWS[1]}: "
                 "build_lm_serve's decode and prefill rows a rank): q, k, "
                 "v, w_gate, w_up (Kc, F/2) with the rows whole, o_proj and "
                 "w_down (Kc/2, F) with the rows rebased, summed; library: "
                 "torch.matmul on the dense bf16 block", sum(
                     v["launches"] for v in dp_serve["lm_serve"].values()),
                 {k: v for k, v in shared_paths.items()
                  if k.startswith("lm_serve")}, dp_serve["kernel_err"])
                for b in sorted({r["B"] for r in dp_serve["kernel_rows"]})})]
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kernels": kernels, "timing": rows,
                       "update_timing": upd_rows, "update_layer": upd_layer,
                       "spmm_train_timing": spmm_rows,
                       "spmm_pod_timing": spmm_pod_rows, "serve": serve,
                       "build": built, "sass": sass,
                       "train": train, "sync_timing": sync_rows,
                       "sync_alone": sync_alone, "train_sync": train_sync,
                       "compact_timing": compact_rows,
                       "shared_timing": shared_rows,
                       "shared_serve": shared_serve,
                       "paper_spmm_timing": paper_spmm_rows,
                       "paper_update_timing": paper_upd_rows,
                       "paper_train": paper, "train_flows": flows,
                       "paper_legacy": paper_legacy, "fig4": fig4,
                       "arch_kernel_timing": arch_rows,
                       "arch_train": arch_train, "arch_serve": arch_serve,
                       "moe_kernel_timing": moe_rows, "moe_update": moe_upd,
                       "moe_small": moe_small, "moe_train": moe_train,
                       "moe_serve": moe_serve,
                       "deepseek_kernel_timing": ds_rows,
                       "deepseek_update": ds_upd,
                       "deepseek_small": ds_small,
                       "deepseek_train": ds_train,
                       "deepseek_serve": ds_serve,
                       "ssm_kernels": ssm_rows, "ssm_small": ssm_small,
                       "ssm_train": ssm_train, "ssm_serve": ssm_serve,
                       "whisper_kernels": whisper_rows,
                       "whisper_small": whisper_small,
                       "whisper_train": whisper_train,
                       "whisper_serve": whisper_serve,
                       "new_sync_leaves": new_sync_rows, "mvue": mvue,
                       "granite_sync": granite_sync,
                       "granite_procs": granite_procs,
                       "fsdp_update": shard_upd, "fsdp": fsdp,
                       "pod_data_sync": pod_sync, "pod_data": pod_data,
                       "ckpt_reshard": reshard, "fleet": fleet,
                       "tp_serve": tp_serve, "dp_serve": dp_serve,
                       "phase_starts": starts,
                       "seconds": time.perf_counter() - t_start}, fh,
                      indent=1, default=str)
    print(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
