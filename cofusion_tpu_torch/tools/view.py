"""Offline results viewer: turn an export directory of the port's CLI (or
the JAX package's) into a PNG snapshot and a self-contained interactive
HTML — the headless stand-in for the reference's Pangolin GUI (3D surfel
view with per-model label colors, camera frustum, trajectories;
GUI/Tools/GUI.h:184-244, GUI/MainController.cpp:511-765).  The port's copy
of tools/view.py: the same flags and the same view.html, on the port's
exporter; no JAX.  Only the PNG snapshot needs matplotlib, imported when
one is asked for; with `--no-png` numpy is enough.

Inputs (produced by the CLI):
  * cloud-<m>.ply   (-em / -icl)  per-model surfel clouds, world frame
  * poses-<m>.txt   (-ep)         TUM trajectories (camera = model 0)

Outputs in the export dir (or --out):
  * view.png   matplotlib 3-panel snapshot: 3D cloud+trajectory, top-down
               (x/z) and side (z/y) orthographic projections
  * view.html  zero-dependency HTML: embedded point data + a vanilla-JS
               canvas orbit viewer (drag = rotate, wheel = zoom) — no CDN,
               works offline

Usage: python -m cofusion_tpu_torch.tools.view --export out [--out DIR]
       [--max-points 200000] [--color label|rgb] [--no-html] [--no-png]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

import numpy as np

from cofusion_tpu_torch.utils.export import _COLOR_TABLE, load_tum_trajectory, read_ply


def _model_id(path: str) -> int:
    m = re.search(r"-(\d+)\.(ply|txt)$", os.path.basename(path))
    return int(m.group(1)) if m else 0


def load_scene(export_dir: str, max_points: int, color_mode: str):
    """Returns (points (N,3), colors (N,3) uint8, trajectories {m: (T,3)})."""
    pts, cols = [], []
    for ply in sorted(glob.glob(os.path.join(export_dir, "cloud-*.ply")), key=_model_id):
        m = _model_id(ply)
        cloud = read_ply(ply)
        p = cloud["pos"]
        if not len(p):
            continue
        if color_mode == "label":
            c = np.tile((_COLOR_TABLE[m % len(_COLOR_TABLE)] * 255).astype(np.uint8), (len(p), 1))
        else:
            c = cloud["color"]
        pts.append(p)
        cols.append(c)
    trajs = {}
    for txt in sorted(glob.glob(os.path.join(export_dir, "poses-*.txt")), key=_model_id):
        _, poses = load_tum_trajectory(txt)
        if len(poses):
            trajs[_model_id(txt)] = np.asarray([T[:3, 3] for T in poses], np.float32)
    if pts:
        p = np.concatenate(pts)
        c = np.concatenate(cols)
        if len(p) > max_points:
            sel = np.random.default_rng(0).choice(len(p), max_points, replace=False)
            p, c = p[sel], c[sel]
    else:
        p = np.zeros((0, 3), np.float32)
        c = np.zeros((0, 3), np.uint8)
    return p, c, trajs


def write_png(path: str, pts, cols, trajs) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(15, 5))
    ax3 = fig.add_subplot(1, 3, 1, projection="3d")
    fc = cols.astype(np.float32) / 255.0
    if len(pts):
        ax3.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=0.3, c=fc, linewidths=0)
    for m, t in trajs.items():
        col = _COLOR_TABLE[(m + 1) % len(_COLOR_TABLE)]
        ax3.plot(t[:, 0], t[:, 2], -t[:, 1], lw=2, color=col, label=f"model {m}")
    ax3.set_title("3D (x, z, -y)")
    if trajs:
        ax3.legend(loc="upper right", fontsize=7)

    for k, (a, b, la, lb, ttl) in enumerate(
        [(0, 2, "x", "z", "top-down"), (2, 1, "z", "y", "side")], start=2
    ):
        ax = fig.add_subplot(1, 3, k)
        if len(pts):
            ax.scatter(pts[:, a], pts[:, b], s=0.25, c=fc, linewidths=0)
        for m, t in trajs.items():
            ax.plot(t[:, a], t[:, b], lw=2, color=_COLOR_TABLE[(m + 1) % len(_COLOR_TABLE)])
        ax.set_xlabel(la)
        ax.set_ylabel(lb)
        ax.set_title(ttl)
        ax.set_aspect("equal", adjustable="datalim")
        if b == 1:
            ax.invert_yaxis()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


_HTML = """<!doctype html><html><head><meta charset="utf-8">
<title>cofusion_tpu viewer</title><style>
body{margin:0;background:#111;color:#ddd;font:13px sans-serif;overflow:hidden}
#hud{position:fixed;top:8px;left:10px;pointer-events:none}
canvas{display:block}</style></head><body>
<div id="hud">drag: rotate &nbsp; wheel: zoom &nbsp; shift-drag: pan<br>__META__</div>
<canvas id="c"></canvas><script>
const PTS=__PTS__,COL=__COL__,TRAJ=__TRAJ__,TCOL=__TCOL__;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let yaw=-.6,pitch=-.4,dist=4,cx=0,cy=0,czn=0;
(function(){let n=PTS.length/3;if(!n)return;let sx=0,sy=0,sz=0;
for(let i=0;i<n;i++){sx+=PTS[3*i];sy+=PTS[3*i+1];sz+=PTS[3*i+2];}
cx=sx/n;cy=sy/n;czn=sz/n;})();
function draw(){
 const W=cv.width=innerWidth,H=cv.height=innerHeight;
 ctx.fillStyle='#111';ctx.fillRect(0,0,W,H);
 const cyaw=Math.cos(yaw),syaw=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 const f=.9*Math.min(W,H);
 function proj(x,y,z){
  x-=cx;y-=cy;z-=czn;
  let X=cyaw*x+syaw*z, Z=-syaw*x+cyaw*z;
  let Y=cp*y-sp*Z, Z2=sp*y+cp*Z+dist;
  if(Z2<=.05)return null;
  return [W/2+f*X/Z2, H/2+f*Y/Z2, Z2];}
 const img=ctx.createImageData(W,H),d=img.data;
 for(let i=0;i<PTS.length/3;i++){
  const p=proj(PTS[3*i],PTS[3*i+1],PTS[3*i+2]);if(!p)continue;
  const px=p[0]|0,py=p[1]|0;if(px<0||py<0||px>=W||py>=H)continue;
  const o=4*(py*W+px);d[o]=COL[3*i];d[o+1]=COL[3*i+1];d[o+2]=COL[3*i+2];d[o+3]=255;}
 ctx.putImageData(img,0,0);
 TRAJ.forEach((t,k)=>{ctx.strokeStyle=TCOL[k];ctx.lineWidth=2;ctx.beginPath();
  let started=false;
  for(let i=0;i<t.length/3;i++){const p=proj(t[3*i],t[3*i+1],t[3*i+2]);
   if(!p){started=false;continue;}
   if(!started){ctx.moveTo(p[0],p[1]);started=true;}else ctx.lineTo(p[0],p[1]);}
  ctx.stroke();});}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup=()=>drag=null;
onmousemove=e=>{if(!drag)return;const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){cx-=dx*dist/900*Math.cos(yaw);czn+=dx*dist/900*Math.sin(yaw);cy-=dy*dist/900;}
 else{yaw+=dx*.008;pitch+=dy*.008;}
 drag=[e.clientX,e.clientY,drag[2]];requestAnimationFrame(draw);};
onwheel=e=>{dist*=Math.exp(e.deltaY*.001);requestAnimationFrame(draw);};
onresize=draw;draw();
</script></body></html>"""


def write_html(path: str, pts, cols, trajs) -> None:
    tr, tc = [], []
    for m, t in trajs.items():
        tr.append(np.round(t.reshape(-1), 4).tolist())
        c = (_COLOR_TABLE[(m + 1) % len(_COLOR_TABLE)] * 255).astype(int)
        tc.append(f"rgb({c[0]},{c[1]},{c[2]})")
    meta = f"{len(pts)} points, {len(trajs)} trajectories"
    html = (
        _HTML.replace("__PTS__", json.dumps(np.round(pts.reshape(-1), 4).tolist()))
        .replace("__COL__", json.dumps(cols.reshape(-1).tolist()))
        .replace("__TRAJ__", json.dumps(tr))
        .replace("__TCOL__", json.dumps(tc))
        .replace("__META__", meta)
    )
    with open(path, "w") as f:
        f.write(html)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--export", required=True)
    ap.add_argument("--out", help="output directory (default: the export dir)")
    ap.add_argument("--max-points", type=int, default=200000)
    ap.add_argument("--color", choices=["label", "rgb"], default="label")
    ap.add_argument("--no-html", action="store_true")
    ap.add_argument("--no-png", action="store_true")
    args = ap.parse_args(argv)

    out_dir = args.out or args.export
    os.makedirs(out_dir, exist_ok=True)
    pts, cols, trajs = load_scene(args.export, args.max_points, args.color)
    if not len(pts) and not trajs:
        print(f"nothing to view in {args.export} (need cloud-*.ply / poses-*.txt)",
              file=sys.stderr)
        return 1
    if not args.no_png:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            print("view.png needs matplotlib, which is not installed; pass --no-png for view.html alone",
                  file=sys.stderr)
            return 1
        p = os.path.join(out_dir, "view.png")
        write_png(p, pts, cols, trajs)
        print(p)
    if not args.no_html:
        p = os.path.join(out_dir, "view.html")
        write_html(p, pts, cols, trajs)
        print(p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
