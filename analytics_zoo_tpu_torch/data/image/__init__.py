from analytics_zoo_tpu_torch.data.image.parquet_dataset import (  # noqa: F401
    Image,
    NDarray,
    ParquetDataset,
    Scalar,
    write_from_directory,
    write_mnist,
    write_ndarrays,
)
