"""The plain reference that decides ``correct``: HMMR in plain PyTorch.

Nothing here imports the measured package, JAX or any kernel: the model,
SMPL, the int8 encoder's quantisation scheme, the losses and Adam are
written out from the published description (Kanazawa et al., CVPR 2019;
slim's resnet_v2_50) with the parameter names the port uses, so that one
set of weights made by the benchmark feeds both sides.
"""
