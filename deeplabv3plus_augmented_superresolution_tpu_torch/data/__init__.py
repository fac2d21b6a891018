from .io import check_hdf5_validity, load_image, load_sr_data, save_img, write_augmented_hdf5
from .paths import (augmented_copies_dir, class_in_image, filter_images_by_class,
                    get_img_paths, list_precomputed_data_paths, standard_output_dir)
from .synthetic import synthetic_batch, synthetic_scene

__all__ = ["check_hdf5_validity", "load_image", "load_sr_data", "save_img",
           "write_augmented_hdf5", "augmented_copies_dir", "class_in_image",
           "filter_images_by_class", "get_img_paths", "list_precomputed_data_paths",
           "standard_output_dir", "synthetic_batch", "synthetic_scene"]
