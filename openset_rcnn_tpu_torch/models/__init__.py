"""ResNet-50 + FPN, the CF-RPN head, the open-set ROI heads, the detector's
inference forward and the fused serving cascade."""
