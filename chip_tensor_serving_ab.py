#!/usr/bin/env python3
"""Time chip_smoke.py's tensor_serving phase of one checkout, alone, on
one GPU, so that two commits can be compared on the same card:

    for t in PARENT CHANGE CHANGE PARENT; do
        python3 chip_tensor_serving_ab.py $t
    done

Each call imports `chip_smoke` from the checkout at the given path, builds
its kernels, makes the serving phase's weights and prompts (SERVE, with
its depth cut where the checkout sets one) without the HTTP run, the
one-device dense engine's greedy tokens on them (what the paged phase
would hand on), then runs `tensor_serving_phase` and prints its seconds
as the last line.  The phase prints its own lines as in the smoke run.
"""
import dataclasses
import os
import sys
import time


def main() -> int:
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('chip_tensor_serving_ab: no CUDA device available',
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from skypilot_tpu_torch.device import resolve_device
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.models.llama import (LLAMA_CONFIGS, Llama,
                                                 init_params)
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    from skypilot_tpu_torch.perf import compile_telemetry

    device = resolve_device('cuda')
    card = torch.cuda.get_device_name(0)
    print(f'{tree}: {cs.nvidia_smi_line()}', flush=True)
    fa.build()
    os.environ[compile_telemetry.STRICT_ENV] = '1'
    serve = cs.SERVE
    cfg = LLAMA_CONFIGS[serve['model']]
    cfg = dataclasses.replace(cfg, n_layers=serve.get('n_layers',
                                                      cfg.n_layers),
                              max_seq_len=serve['max_seq_len'],
                              param_dtype=torch.bfloat16)
    params = init_params(cfg, device,
                         torch.Generator(device=device).manual_seed(cs.SEED))
    model = Llama(cfg, params)
    rng = np.random.default_rng(cs.SEED)
    prompts = [rng.integers(0, cfg.vocab_size, serve['prompt_len']).tolist()
               for _ in range(serve['n_prompts'])]
    long_prompt = rng.integers(0, cfg.vocab_size,
                               serve['long_prompt_len']).tolist()
    ctx = {'cfg': cfg, 'params': params, 'model': model, 'prompts': prompts,
           'long_prompt': long_prompt}
    engine = DecodeEngine(model, EngineConfig(
        n_slots=cs.PAGED['n_slots'], steps_per_call=cs.PAGED['steps_per_call'],
        prefill_buckets=cs.PAGED['prefill_buckets']), device=device)
    engine.prewarm()
    ctx['dense_toks'] = cs._drive(engine, prompts + [long_prompt],
                                  cs.PAGED['max_tokens'])[0]
    del engine
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cs.tensor_serving_phase(device, card, ctx)
    print(f'{tree}: tensor_serving {time.perf_counter() - t0:.1f} s on '
          f'{card}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
