"""active_3d_vision_and_touch_tpu_torch — the PyTorch/CUDA port of
``active_3d_vision_and_touch_tpu`` for NVIDIA Hopper (H100).

It imports torch and numpy and nothing of JAX or of the JAX package, which
stays beside it as the reference the tests hold it against.  Layers
follow the JAX package's:

- ``core``   host geometry: chart meshes, adjacency build/fuse, camera, config
- ``ops``    Chamfer on the hand-written exact-NN, clustered-NN and
             segment-sum CUDA kernels (``csrc/``), area-weighted sampling,
             NeRF encoding, bilinear pooling
- ``models`` the vision ``Deformation`` network (CNN pyramids + GCN stages,
             touch-context and plane pathways), the ``TouchChartEncoder``
             and the ``MeshAutoEncoder``
- ``train``  the vision, touch and autoencoder trainers (``VisionEngine``,
             ``TouchEngine``, ``AutoencoderEngine``), checkpoints, early stop
- ``data``   the trainers' and the rollout datasets, their prefetching
             loader, procedural objects and dataset generation (host, numpy)
- ``sim``    the host simulator: hand, grasps, gel and scene renderers
- ``active`` the active-touch environment and the policies
- ``parallel`` process groups, device meshes and batch sharding over
             ``torch.distributed``; the trainers train across its ranks
- ``utils``  plots and renders written as PNGs, ``torch.profiler`` traces
- ``cli``, ``bench`` the command line and the headline benchmark
- ``convert`` flax variables → the port's ``state_dict``s

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU.  Kernels are built with ``nvcc`` at their first use.
"""

__version__ = "0.1.0"
