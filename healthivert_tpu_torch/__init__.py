"""HealthiVert on PyTorch and CUDA: `healthivert_tpu`'s serving and training
paths and their command lines, ported to an NVIDIA H100.

The JAX package `healthivert_tpu` stays the reference; this package keeps
its layout so that each module has a counterpart there:

ops      nearest resize, Sobel edges, SHRM paste-back, contextual attention,
         and the wrappers of the hand-written CUDA attention kernels
         (forward, backward, v1 on patch tensors); the binding of the host
         geometry library of the de-pedicle masks (native/geometry.cpp)
models   spectral-norm conv blocks, the two-stage generator, the
         discriminators, generator_forward and train_step; the HGAM
         fracture classifier and Grad-CAM++
data     host-side (numpy) slice sampling, the straightened dataset,
         synthetic spine volumes (straightened and raw), device prefetch
straighten  spine straightening: centroids, the curve resample (on the
         card), the de-pedicle masks and crops
engine   checkpoints, the three-pass 3D synthesis, the training loop,
         evaluation and the visualizer (logs, galleries, PNGs)
evaluation  the offline evaluation: generation metrics, RHLV, the SVM
         Genant grading (its own linear SVC and metrics, numpy)
config   the command-line options
cli      the entry points: location_json_local, straighten_mask_3d,
         eval_3d_sagittal_twostage, train, test, grad_cam_3d_sagittal,
         generation_eval_{sagittal,coronal}, rhlv_quantification{,_coronal},
         svm_grading, svm_grading_2_5d (python -m
         healthivert_tpu_torch.cli.<name>); each sets exact float32 first
utils    NIfTI IO, the CSV table, flax-tree and .pth conversion, device
         selection and the float32 precision
experiments  the attention forward's stage ablation (run on the card)

Public functions take and return NHWC tensors, as the JAX package does.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
CUDA tensor the attention wrapper launches its kernel or raises, and on a
CPU tensor it runs the kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
