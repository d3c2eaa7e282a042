"""The benchmark's plain reference: voxelgrid downsampling, brute-force kNN
covariances, GICP with Levenberg-Marquardt, in plain PyTorch, computed in
float64 from the raw inputs. It imports nothing of the program under test
and takes nothing the program made, apart from the program state that a
check names (the odometry map a frame is aligned against).

``Precision("tf32")`` computes the same arithmetic in float32 with every
stage's inputs and outputs rounded to TF32's 10-bit mantissa: the control,
the step below the configuration's float32 that a later change could be
tempted to take (tensor-core distances and sums).
"""
