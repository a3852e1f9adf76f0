"""Video trim / crop / resize CLI (counterpart of
``anyv2v_tpu/cli/prepare_video.py``; the reference ``prepare_video.py``'s
arguments, :108-148), on OpenCV.

Usage:
    python -m anyv2v_torch.cli.prepare_video --video_path in.mp4 \\
        --output_folder prepared --width 512 --height 512 --start_time 0 \\
        --clip_duration 2 --center_crop
"""

from __future__ import annotations

import argparse
import glob
import os

from ..utils.video_prep import crop_and_resize_video


def process_videos(input_folder: str, output_folder: str, **kwargs) -> None:
    video_files = glob.glob(os.path.join(input_folder, "*.mp4"))
    if not video_files:
        print(f"No video files found in {input_folder}")
        return
    for video_file in video_files:
        crop_and_resize_video(video_file, output_folder, **kwargs)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Crop and resize video segments.")
    parser.add_argument("--input_folder", type=str)
    parser.add_argument("--video_path", type=str, default=None)
    parser.add_argument("--output_folder", type=str, default="processed_video_data")
    parser.add_argument("--clip_duration", type=int, default=2)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--start_time", type=float)
    parser.add_argument("--end_time", type=float)
    parser.add_argument("--n_frames", type=int, default=16)
    parser.add_argument("--center_crop", action="store_true")
    parser.add_argument("--x_offset", type=float, default=0)
    parser.add_argument("--y_offset", type=float, default=0)
    parser.add_argument("--longest_to_width", action="store_true")
    parser.add_argument("--use_full_clip", action="store_true")
    args = parser.parse_args(argv)

    if args.start_time and args.end_time:
        print("Please specify only one of start_time or end_time, not both.")
        return

    kwargs = dict(
        clip_duration=args.clip_duration, width=args.width, height=args.height,
        start_time=args.start_time, end_time=args.end_time,
        n_frames=args.n_frames, center_crop=args.center_crop,
        x_offset=args.x_offset, y_offset=args.y_offset,
        longest_to_width=args.longest_to_width, use_full_clip=args.use_full_clip,
    )
    if args.video_path:
        crop_and_resize_video(args.video_path, args.output_folder, **kwargs)
    else:
        process_videos(args.input_folder, args.output_folder, **kwargs)


if __name__ == "__main__":
    main()
