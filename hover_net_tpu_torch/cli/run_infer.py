"""Inference CLI of the port: the `tile` and `wsi` subcommands.

Counterpart of hover_net_tpu/cli/run_infer.py, with the same flags plus
`--device` (default `cuda`; without a GPU that raises, it never falls
back to the CPU). `--model_path` takes a reference PyTorch `.tar`, the
port trainer's `.tar`, or the JAX package's `.msgpack` as its trainer
writes it (`net_epoch=N.msgpack`), read without flax.

  python -m hover_net_tpu_torch.cli.run_infer \
      --model_path ckpt.tar --model_mode fast --nr_types 6 \
      --type_info_path type_info.json \
      tile --input_dir in/ --output_dir out/ --save_qupath

  python -m hover_net_tpu_torch.cli.run_infer \
      --model_path ckpt.tar --model_mode fast \
      wsi --input_dir slides/ --output_dir out/ --proc_mag 40

`--model_mode` picks the model (models/zoo.py): HoVer-Net in `fast`
(256 -> 164 patches) or `original` (270 -> 80) mode at `--width`, or
CellViT-SAM-H in `cellvit_sam_h` (ViT-H encoder with windowed and global
attention, 1024 -> 960 patches, batch 8 by default, typed: give
`--nr_types 6` for PanNuke; `--model_path` a CellViT `.pth` or a `.tar`):

  python -m hover_net_tpu_torch.cli.run_infer \
      --model_path CellViT-SAM-H-x40.pth --model_mode cellvit_sam_h \
      --nr_types 6 --type_info_path type_info.json \
      wsi --input_dir slides/ --output_dir out/

On a GPU a fast-mode model (bf16, as both subcommands build it) whose
4 * width is a multiple of 128 runs its encoder d0..d2 as the fused-block
CUDA kernel K3 (infer/steps._use_fused_enc). `--host_post_proc` (tile)
post-processes on the host with the oracle (ops/post_proc_host.process)
instead of the device kernel; `--profile_dir DIR` writes a
torch.profiler trace of the run (tile or wsi) under DIR.

`--n_devices N` runs on N cards from `--device` on (clamped, with a
warning, to the cards there are; the CPU is one device): `tile` hands
successive images to the cards in turn, `wsi` builds the mesh of
infer/wsi.py, with the stitched prediction map row-striped over the
cards and each card post-processing its share of every window batch.
"""

from __future__ import annotations

import argparse
import logging

from ..models.zoo import DEFAULT_BATCH, MODES


def build_parser():
    p = argparse.ArgumentParser("hover_net_tpu_torch.run_infer")
    p.add_argument("--nr_types", type=int, default=0,
                   help="number of nuclei types (0 = segmentation only)")
    p.add_argument("--type_info_path", default=None)
    p.add_argument("--model_path", required=True,
                   help="checkpoint: a reference-format .tar or a "
                        "JAX .msgpack")
    p.add_argument("--model_mode", default="fast", choices=MODES)
    p.add_argument("--batch_size", type=int, default=None,
                   help="patches a forward batch (default: 32 for "
                        "HoVer-Net, 8 for CellViT)")
    p.add_argument("--width", type=int, default=64,
                   help="HoVer-Net's width (CellViT's are the published)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    p.add_argument("--nr_inference_workers", type=int, default=8,
                   help="accepted for parity; patches are gathered on the "
                        "device")
    p.add_argument("--nr_post_proc_workers", type=int, default=0,
                   help="accepted for parity; post-processing runs on the "
                        "device")
    p.add_argument("--host_post_proc", action="store_true",
                   help="tile mode: post-process on the host with the "
                        "cv2/scipy oracle instead of the device kernel")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the run here "
                        "(open in TensorBoard or chrome://tracing)")
    p.add_argument("--n_devices", type=int, default=1,
                   help="devices to run on, from --device on: tile mode "
                        "round-robins images over them, wsi mode stripes "
                        "the prediction map and post-processing over them")

    sub = p.add_subparsers(dest="command", required=True)
    tile = sub.add_parser("tile")
    tile.add_argument("--input_dir", required=True)
    tile.add_argument("--output_dir", required=True)
    tile.add_argument("--mem_usage", type=float, default=0.2,
                      help="accepted for parity; one image at a time")
    tile.add_argument("--draw_dot", action="store_true")
    tile.add_argument("--save_qupath", action="store_true")
    tile.add_argument("--save_raw_map", action="store_true")
    tile.add_argument("--save_format", default="all", choices=["all", "json"],
                      help="'all' writes mat/overlay/json; 'json' writes "
                           "only the per-nucleus json (+qupath)")
    wsi = sub.add_parser("wsi")
    wsi.add_argument("--input_dir", required=True)
    wsi.add_argument("--output_dir", required=True)
    wsi.add_argument("--input_mask_dir", default=None)
    wsi.add_argument("--cache_path", default="cache")
    wsi.add_argument("--proc_mag", type=int, default=40)
    wsi.add_argument("--ambiguous_size", type=int, default=128)
    wsi.add_argument("--chunk_shape", type=int, default=10000)
    wsi.add_argument("--tile_shape", type=int, default=2048)
    wsi.add_argument("--save_thumb", action="store_true")
    wsi.add_argument("--save_mask", action="store_true")
    wsi.add_argument("--pred_map_f32", action="store_true",
                     help="stitched prediction map in float32 (the "
                          "reference's dtype) instead of float16")
    wsi.add_argument("--hbm_pred_budget_gb", type=float, default=4.0,
                     help="keep the stitched prediction map in device "
                          "memory when it fits this budget; 0 forces the "
                          "mmap path")
    return p


def main(argv=None):
    """Runs the subcommand; returns its manager."""
    from .. import runtime

    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="|%(asctime)s.%(msecs)03d| [%(levelname)s] %(message)s",
        datefmt="%Y-%m-%d|%H:%M:%S")

    common = dict(
        model_path=args.model_path, mode=args.model_mode,
        nr_types=args.nr_types if args.nr_types > 0 else None,
        type_info_path=args.type_info_path,
        batch_size=args.batch_size or DEFAULT_BATCH[args.model_mode],
        width=args.width, device=args.device, n_devices=args.n_devices)
    with runtime.profile_trace(args.profile_dir):
        if args.command == "tile":
            from ..infer.tile import TileInferManager

            mgr = TileInferManager(device_post_proc=not args.host_post_proc,
                                   **common)
            mgr.process_file_list(
                args.input_dir, args.output_dir, draw_dot=args.draw_dot,
                save_qupath=args.save_qupath, save_raw_map=args.save_raw_map,
                save_format=args.save_format)
        else:
            from ..infer.wsi import WSIInferManager

            mgr = WSIInferManager(
                chunk_shape=args.chunk_shape, tile_shape=args.tile_shape,
                ambiguous_size=args.ambiguous_size, proc_mag=args.proc_mag,
                cache_path=args.cache_path,
                pred_map_dtype="float32" if args.pred_map_f32 else "float16",
                hbm_pred_budget=int(args.hbm_pred_budget_gb * 2**30),
                **common)
            mgr.process_wsi_list(
                args.input_dir, args.output_dir,
                input_mask_dir=args.input_mask_dir,
                save_thumb=args.save_thumb, save_mask=args.save_mask)
    return mgr


if __name__ == "__main__":
    main()
