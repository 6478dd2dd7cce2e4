"""The plain reference that decides ``correct``: the agent net, the VDN
learner, the DMFB and MEDA steps and the actor loop, in plain PyTorch,
float32 with TF32 off.  It imports nothing of the measured program."""
