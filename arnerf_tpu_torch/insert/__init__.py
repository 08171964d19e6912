"""AR object insertion (port of arnerf_tpu/insert/; reference insert/):
SH/SG lighting math, global-light inverse rendering, light probes, PBR
render cores, shadow fields, SG-SSDF shadows, environment-map SG fitting,
tonemapping, and the TCP viewer protocol. Entry point:

  python -m arnerf_tpu_torch.insert.main --dataset_name synthetic \
      --ckpt_path ckpt.npz --exp_name scene [--device cpu]
"""
