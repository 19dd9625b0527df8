"""The U-Net, the VAE decoder and the pose projection."""
