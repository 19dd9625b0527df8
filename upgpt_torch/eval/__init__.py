"""Evaluation: SSIM, MS-SSIM, LPIPS, the FID InceptionV3 and the
`cli test` / `cli eval` harness (port of `upgpt_tpu.eval`)."""
