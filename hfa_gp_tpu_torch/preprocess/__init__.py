"""The preprocessing chain (port of hfa_gp_tpu/preprocess): video frames →
MTCNN → Deep3DFaceRecon → EG3D crops and camera labels, and 16 kHz audio →
DeepSpeech features."""
