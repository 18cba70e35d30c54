"""The port's own copies of the JAX package's sim environments
(``visual_foresight_tpu/envs``: the base env, the MuJoCo base and the
cartgripper envs the benchmark campaigns run): that package imports JAX when
any of its modules is imported, and these hold no JAX code."""
