"""tpu3d_torch.tools — eval programs of the port."""
