"""The backbones (ResNet + FPN, Swin Transformer + FPN, ViT with its simple
pyramid), the CF-RPN head, the open-set ROI heads, the detector's
inference forward and the fused serving cascade."""
