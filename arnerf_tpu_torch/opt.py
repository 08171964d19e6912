"""CLI flags: the JAX package's get_opts (arnerf_tpu/opt.py; reference
opt.py:3-112), same names, defaults and choices, plus --device and the
port's size flags."""

import argparse


def get_opts(args=None):
    parser = argparse.ArgumentParser()

    # dataset parameters
    parser.add_argument('--root_dir', type=str, required=False, default='',
                        help='root directory of dataset')
    parser.add_argument('--dataset_name', type=str, default='nsvf',
                        choices=['nerf', 'nsvf', 'colmap', 'colmap_exr',
                                 'colmap_real_exr', 'myblender', 'nerfpp',
                                 'rtmv', 'synthetic'],
                        help='which dataset to train/test')
    parser.add_argument('--split', type=str, default='train',
                        choices=['train', 'trainval', 'trainvaltest'])
    parser.add_argument('--downsample', type=float, default=1.0)

    # model parameters
    parser.add_argument('--scale', type=float, default=0.5,
                        help='scene scale: scene lies in [-scale, scale]^3')
    parser.add_argument('--use_exposure', action='store_true', default=False,
                        help='whether to train in HDR-NeRF setting')

    # loss parameters
    parser.add_argument('--distortion_loss_w', type=float, default=0)
    parser.add_argument('--depth_loss_w', type=float, default=0)
    parser.add_argument('--loss_func', type=str, default='raw',
                        choices=['raw', 'log', 'tanh'])

    # training options
    parser.add_argument('--batch_size', type=int, default=8192)
    parser.add_argument('--ray_sampling_strategy', type=str,
                        default='all_images',
                        choices=['all_images', 'same_image'])
    parser.add_argument('--num_epochs', type=int, default=30)
    parser.add_argument('--num_gpus', type=int, default=1)
    parser.add_argument('--model_parallel', type=int, default=1,
                        help='model-axis size for sharded hash-table '
                             'training (num_gpus % model_parallel == 0)')
    parser.add_argument('--lr', type=float, default=1e-2)
    parser.add_argument('--optimize_ext', action='store_true', default=False)
    parser.add_argument('--random_bg', action='store_true', default=False)

    # validation options
    parser.add_argument('--val_batch_size', type=int, default=2**20)
    parser.add_argument('--eval_lpips', action='store_true', default=False)
    parser.add_argument('--val_only', action='store_true', default=False)
    parser.add_argument('--no_save_test', action='store_true', default=False)

    # misc
    parser.add_argument('--exp_name', type=str, default='exp')
    parser.add_argument('--ckpt_path', type=str, default=None)
    parser.add_argument('--weight_path', type=str, default=None)

    # GUI
    parser.add_argument('--low_resolution', type=float, default=1.0)

    # Insertor
    parser.add_argument('--max_pc_pts_num', type=int, default=int(1e6))
    parser.add_argument('--no_global_SH', action='store_true', default=False)

    # compute type ('auto' = float32 on cpu; on cuda bfloat16 for training
    # and float32 for eval; the reference hard-codes fp16 autocast,
    # train.py:291)
    parser.add_argument('--compute_dtype', type=str, default='auto',
                        choices=['auto', 'float32', 'bfloat16'],
                        help='field-eval dtype (float32 accumulation)')
    parser.add_argument('--stoch_corners', type=str, default='auto',
                        choices=['auto', 'on', 'off'],
                        help='stochastic single-corner hash gathers on the '
                             'training paths')
    parser.add_argument('--seg_pool', type=str, default='on',
                        choices=['on', 'off'],
                        help='shared cross-ray segment pool for two-level '
                             'train marching')

    # HDR
    parser.add_argument('--train_SH_HDR_mapping', action='store_true',
                        default=False)
    parser.add_argument('--gen_probe_HDR_mapping', action='store_true',
                        default=False)
    parser.add_argument('--render_HDR_mapping', action='store_true',
                        default=False)
    parser.add_argument('--use_EXR', action='store_true', default=False)

    # the port's device: entry points run on the card unless told otherwise
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default) or 'cpu'; cuda without a "
                             "usable card is an error")
    # the port's own size flags (defaults: the JAX package's full-width
    # model and 1000-step epochs), for small CPU runs and tests; train and
    # eval must be given the same model sizes
    parser.add_argument('--steps_per_epoch', type=int, default=1000)
    parser.add_argument('--grid_size', type=int, default=128)
    parser.add_argument('--n_levels', type=int, default=16)
    parser.add_argument('--log2_hashmap_size', type=int, default=19)

    return parser.parse_args(args)


def resolve_compute_dtype(compute_dtype: str, device,
                          auto_on_cuda: str = 'bfloat16') -> str:
    """'auto' -> `auto_on_cuda` on cuda (bf16 for training, train.py:67-75),
    'float32' on cpu."""
    if compute_dtype == 'auto':
        return auto_on_cuda if device.type == 'cuda' else 'float32'
    return compute_dtype


def model_config(hparams, device, auto_on_cuda: str = 'bfloat16', **kw):
    """The NGPConfig the flags describe on `device` (train.py:59-79):
    --compute_dtype auto is `auto_on_cuda` on the card (bf16 for training;
    eval passes float32, as the JAX eval.py:54-55 renders in f32), the
    fused head on the card, the size flags."""
    from .models import NGPConfig
    rgb_act = 'None' if (hparams.use_exposure or hparams.use_EXR) \
        else 'Sigmoid'
    return NGPConfig(scale=hparams.scale, rgb_act=rgb_act,
                     use_raw_hdr=hparams.use_EXR,
                     compute_dtype=resolve_compute_dtype(
                         hparams.compute_dtype, device, auto_on_cuda),
                     fused_head=device.type == 'cuda',
                     grid_size=hparams.grid_size, n_levels=hparams.n_levels,
                     log2_hashmap_size=hparams.log2_hashmap_size, **kw)
