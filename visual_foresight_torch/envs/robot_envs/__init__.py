"""Robot environments (the port's copy of the JAX package's tree, started with
the kinematics that the sawyer MuJoCo envs share with the robot path)."""
