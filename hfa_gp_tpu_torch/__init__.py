"""hfa_gp_tpu_torch — the PyTorch + CUDA port of `hfa_gp_tpu`, for one
NVIDIA H100 (sm_90a).

The JAX package beside it is the reference; this package imports `torch`
and never `jax`. Module paths mirror the JAX package
(`hfa_gp_tpu/models/eg3d/renderer.py` ↔
`hfa_gp_tpu_torch/models/eg3d/renderer.py`), and so do the param-tree keys:
a `state_dict` key is the JAX flat-npz key with `/` replaced by `.`.

Layout:
  core/ops.py, core/camera.py   StyleGAN2 primitives (NCHW inside), camera math
  core/kernels/                 dispatching wrappers of the hand-written CUDA
                                kernels in csrc/ (autograd Functions on CUDA),
                                each with its plain PyTorch version and a
                                launch counter
  models/eg3d/                  mapping, tri-plane backbone, SR head, renderer
  models/avatar/                encoder, QR subspace, RGB head
  models/lpips.py               LPIPS (AlexNet) perceptual distance
  train/                        RGB-fitting step, Adam + freeze gate,
                                checkpoints
  data/dataset.py               frame readers, batch iterator
  utils/convert.py              JAX param tree / flat npz → modules
  cli/train_rgb.py              RGB fitting entry point
  cli/run_recon_video_rgb.py    RGB-driven reenactment entry point
  preprocess/                   video frames → MTCNN → face recon → EG3D crops
                                and labels; wav → DeepSpeech aud.npy
  cli/process_video.py, cli/extract_audio.py   their entry points
  tools/                        self-reconstruction fit, training-step profile

Public functions keep the JAX layouts: images (B, H, W, 3) in [-1, 1],
planes (B, 3, H, W, C), rays (B, R, 3). The slice runs in fp32.
"""

__version__ = "0.1.0"
