"""What the port carries of gpt2_vision_language_tpu/parallel: the process
mesh and the ring handle (``mesh``), the collectives of data, tensor and
pipeline parallelism (``collectives``), the Megatron split with sequence
parallelism and the placement of a rank's part of the model and its moments
(``sharding``), and the GPipe pipeline (``pipeline``)."""
