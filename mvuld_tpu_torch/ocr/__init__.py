"""The OCR subsystem: EAST text detection, its ground truth and trainer's
pieces, locality-aware NMS and the line-number reader (counterpart of
``mvuld_tpu/ocr``).

Every module imports without PIL and cv2: the GPU machine has neither.
``gt.rasterize_gt``, the numpy half of ``detect`` and ``east`` run there;
``gt.crop_with_text``, ``detect.detect_image`` / ``detect_dataset_map`` and
``recognize`` import PIL (and cv2) inside the functions that need them.
"""
